from .executor import AsyncTrialExecutor, run_trial_segment
from .feature import rolling_window, train_val_split, Scaler
from .forecaster import LSTMForecaster, TCNForecaster, build_forecaster
from .recipe import LSTMRandomRecipe, TCNRandomRecipe, Recipe
from .scheduler import (AshaScheduler, Decision, RunToCompletionScheduler,
                        TrialScheduler)
from .search import (AshaSearchEngine, AutoForecaster, Choice,
                     GridSearchEngine, RandInt, RandomSearchEngine, Uniform,
                     grid_configs, select_best)

__all__ = ["rolling_window", "train_val_split", "Scaler", "LSTMForecaster",
           "TCNForecaster", "build_forecaster", "Recipe", "LSTMRandomRecipe",
           "TCNRandomRecipe", "AutoForecaster", "Choice", "Uniform",
           "RandInt", "RandomSearchEngine", "GridSearchEngine",
           "AshaSearchEngine", "grid_configs", "select_best",
           "AshaScheduler", "Decision", "RunToCompletionScheduler",
           "TrialScheduler", "AsyncTrialExecutor", "run_trial_segment"]
