"""Hyperparameter search over the RayContext runtime.

Counterpart of ``analytics_zoo_tpu/automl/search.py``. The reference's
AutoML (off-tree ``automl`` branch; SURVEY.md §2.8 build-plan item 10)
searches forecaster configs with Ray Tune on a RayOnSpark cluster. Here:
search-space primitives and random/grid/ASHA engines that dispatch one
trial per task onto :class:`analytics_zoo_tpu_torch.ray.RayContext`
workers (separate processes, each on its context's device), with the
driver collecting (config, val_loss) pairs and refitting the best config.
"""

from __future__ import annotations

import itertools
import logging
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import telemetry

logger = logging.getLogger("analytics_zoo_tpu_torch.automl")


# ---------------------------------------------------------------------------
# search-space primitives (hp.* equivalents)
# ---------------------------------------------------------------------------

class Choice:
    def __init__(self, options: Sequence):
        self.options = list(options)

    def sample(self, rng):
        return self.options[int(rng.integers(len(self.options)))]

    def grid(self):
        return self.options


class Uniform:
    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))

    def grid(self):
        return [self.low, (self.low + self.high) / 2, self.high]


class RandInt:
    def __init__(self, low: int, high: int):
        self.low, self.high = int(low), int(high)

    def sample(self, rng):
        return int(rng.integers(self.low, self.high + 1))

    def grid(self):
        return list(range(self.low, self.high + 1))


def sample_config(space: Dict, rng) -> Dict:
    return {k: (v.sample(rng) if hasattr(v, "sample") else v)
            for k, v in space.items()}


#: default ceiling on grid enumeration — a wide ``RandInt`` silently
#: cross-products into thousands of full-budget trials otherwise
DEFAULT_GRID_LIMIT = 256


def grid_configs(space: Dict, limit: Optional[int] = DEFAULT_GRID_LIMIT
                 ) -> List[Dict]:
    keys, values = [], []
    for k, v in space.items():
        keys.append(k)
        values.append(v.grid() if hasattr(v, "grid") else [v])
    total = 1
    for vals in values:
        total *= len(vals)
    if limit is not None and total > limit:
        raise ValueError(
            f"grid search would enumerate {total} trials "
            f"(> max_grid_trials={limit}); narrow the space or use the "
            f"'random' or 'asha' engines, which sample a fixed "
            f"num_samples instead of cross-producting every dimension")
    return [dict(zip(keys, combo)) for combo in itertools.product(*values)]


# ---------------------------------------------------------------------------
# trial fn (runs inside a worker process)
# ---------------------------------------------------------------------------

def run_trial(config: Dict, x_train, y_train, x_val, y_val) -> Dict:
    """Train one forecaster config; returns {config, val_loss, seconds}."""
    from .forecaster import build_forecaster

    t0 = time.time()
    cfg = dict(config)
    batch_size = int(cfg.pop("batch_size", 32))
    epochs = int(cfg.pop("epochs", 1))
    f = build_forecaster(lookback=x_train.shape[1],
                         feature_dim=x_train.shape[2],
                         horizon=y_train.shape[1], **cfg)
    f.fit(x_train, y_train, batch_size=batch_size, epochs=epochs)
    metrics = f.evaluate(x_val, y_val, batch_size=batch_size)
    loss = float(metrics["loss"] if isinstance(metrics, dict) else metrics)
    return {"config": config, "val_loss": loss,
            "seconds": time.time() - t0}


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def select_best(trials: Sequence[Dict]) -> Dict:
    """Best finite-loss trial; non-finite/failed trials never win.

    A diverged trial reports NaN/Inf val loss — ``min()`` over raw
    values lets NaN win the search (NaN comparisons are False both
    ways).  Trials without a finite ``val_loss`` (or already marked
    ``failed``) are excluded; if *every* trial failed the search raises
    instead of returning garbage.
    """
    eligible = []
    for t in trials:
        loss = t.get("val_loss")
        finite = loss is not None and math.isfinite(float(loss))
        if t.get("state") not in ("failed",) and finite:
            eligible.append(t)
        elif "state" not in t:
            t["state"] = "failed"
    if not eligible:
        errors = [str(t.get("error") or f"val_loss={t.get('val_loss')!r}")
                  for t in trials[:5]]
        raise RuntimeError(
            f"all {len(trials)} trials failed — no finite val_loss to "
            f"select from (first errors: {errors})")
    best = min(eligible, key=lambda t: float(t["val_loss"]))
    telemetry.gauge("zoo_automl_best_val_loss").set(
        float(best["val_loss"]))
    return best


class _EngineBase:
    def __init__(self, ray_ctx=None):
        self.ray_ctx = ray_ctx
        self.trials: List[Dict] = []
        self.stats: Dict = {}

    def _configs(self, space, num_samples, seed) -> List[Dict]:
        raise NotImplementedError

    def run(self, space: Dict, data: Tuple, num_samples: int = 4,
            epochs: int = 1, seed: int = 0) -> Dict:
        """data = (x_train, y_train, x_val, y_val). Returns the best trial."""
        x_train, y_train, x_val, y_val = data
        configs = self._configs(space, num_samples, seed)
        for c in configs:
            c.setdefault("epochs", epochs)
        if self.ray_ctx is not None and not self.ray_ctx.stopped:
            refs = [self.ray_ctx.remote(run_trial).remote(
                c, x_train, y_train, x_val, y_val) for c in configs]
            self.trials = self.ray_ctx.get(refs)
        else:
            self.trials = [run_trial(c, x_train, y_train, x_val, y_val)
                           for c in configs]
        best = select_best(self.trials)
        logger.info("search done: %d trials, best %.5f %s",
                    len(self.trials), best["val_loss"], best["config"])
        return best


class RandomSearchEngine(_EngineBase):
    def _configs(self, space, num_samples, seed):
        rng = np.random.default_rng(seed)
        return [sample_config(space, rng) for _ in range(num_samples)]


class GridSearchEngine(_EngineBase):
    def __init__(self, ray_ctx=None, max_grid_trials: int =
                 DEFAULT_GRID_LIMIT):
        super().__init__(ray_ctx)
        self.max_grid_trials = max_grid_trials

    def _configs(self, space, num_samples, seed):
        return grid_configs(space, limit=self.max_grid_trials)


class AshaSearchEngine(_EngineBase):
    """Asynchronous successive halving over the async executor.

    Samples ``num_samples`` configs like random search, but instead of
    training each to the full budget it drives them through
    :class:`~analytics_zoo_tpu_torch.automl.scheduler.AshaScheduler` rungs
    at ``min_epochs·η^k`` epochs on an
    :class:`~analytics_zoo_tpu_torch.automl.executor.AsyncTrialExecutor`:
    trials report at rung boundaries, losers stop early, winners resume
    from their checkpoint — same trial budget as random, a fraction of
    the trained epochs, so best-val-loss per wall-hour scales with the
    worker pool instead of the slowest bracket (docs/automl.md).

    ``epochs`` (from the recipe) is the *maximum* per-trial budget R;
    ``min_epochs`` (r) and ``reduction_factor`` (η) shape the rungs.
    """

    def __init__(self, ray_ctx=None, min_epochs: int = 1,
                 reduction_factor: int = 3,
                 max_concurrent: Optional[int] = None,
                 workdir: Optional[str] = None, serial: bool = False):
        super().__init__(ray_ctx)
        self.min_epochs = int(min_epochs)
        self.reduction_factor = int(reduction_factor)
        self.max_concurrent = max_concurrent
        self.workdir = workdir
        self.serial = serial

    def run(self, space: Dict, data: Tuple, num_samples: int = 4,
            epochs: int = 1, seed: int = 0) -> Dict:
        from .executor import AsyncTrialExecutor
        from .scheduler import AshaScheduler

        rng = np.random.default_rng(seed)
        configs = [sample_config(space, rng) for _ in range(num_samples)]
        for c in configs:
            # segment budgets come from the scheduler
            # (run_trial_segment pops this key), but the winning config
            # must still carry the full budget so AutoForecaster's final
            # refit trains recipe.epochs, not the 1-epoch fallback
            c.setdefault("epochs", epochs)
        scheduler = AshaScheduler(
            max_epochs=epochs, min_epochs=min(self.min_epochs, epochs),
            reduction_factor=self.reduction_factor)
        executor = AsyncTrialExecutor(
            scheduler, ray_ctx=self.ray_ctx,
            max_concurrent=self.max_concurrent, workdir=self.workdir,
            serial=self.serial)
        self.trials = executor.run(configs, data)
        self.stats = dict(executor.stats, rungs=scheduler.rungs())
        best = select_best(self.trials)
        logger.info(
            "asha done: %d trials (%d completed / %d stopped / %d "
            "failed), %d epochs trained, best %.5f %s",
            len(self.trials), self.stats.get("completed", 0),
            self.stats.get("stopped", 0), self.stats.get("failed", 0),
            self.stats.get("epochs_trained", 0), best["val_loss"],
            best["config"])
        return best


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

class AutoForecaster:
    """AutoTSTrainer-style facade: search a recipe, refit the winner.

    >>> auto = AutoForecaster(recipe=LSTMRandomRecipe(num_samples=4),
    ...                       ray_ctx=ctx)
    >>> pipeline = auto.fit(series, lookback=24, horizon=1)
    >>> preds = pipeline.predict(x)
    """

    #: engine name -> class; ``AutoForecaster(engine=...)`` validates
    #: against this map instead of silently defaulting unknowns to grid
    ENGINES = {"random": RandomSearchEngine, "grid": GridSearchEngine,
               "asha": AshaSearchEngine}

    def __init__(self, recipe, ray_ctx=None, engine: str = "random",
                 **engine_kwargs):
        self.recipe = recipe
        cls = self.ENGINES.get(engine)
        if cls is None:
            raise ValueError(
                f"unknown search engine {engine!r}; valid engines: "
                f"{sorted(self.ENGINES)}")
        self.engine = cls(ray_ctx, **engine_kwargs)
        self.best_trial: Optional[Dict] = None
        self.forecaster = None

    def fit(self, series: np.ndarray, lookback: int, horizon: int = 1,
            val_ratio: float = 0.2, seed: int = 0):
        from .feature import Scaler, rolling_window, train_val_split
        from .forecaster import build_forecaster

        self.scaler = Scaler()
        scaled = self.scaler.fit_transform(series)
        x, y = rolling_window(scaled, lookback, horizon)
        (x_tr, y_tr), (x_val, y_val) = train_val_split(x, y, val_ratio)
        self.best_trial = self.engine.run(
            self.recipe.search_space(), (x_tr, y_tr, x_val, y_val),
            num_samples=self.recipe.num_samples, epochs=self.recipe.epochs,
            seed=seed)
        # refit the winning config on the full window set (driver process);
        # fall back to the recipe's budget if the config lacks "epochs"
        # (an engine that strips it must not shrink the refit to 1 epoch)
        cfg = dict(self.best_trial["config"])
        batch_size = int(cfg.pop("batch_size", 32))
        epochs = int(cfg.pop("epochs",
                             getattr(self.recipe, "epochs", 1)))
        self.forecaster = build_forecaster(
            lookback=lookback, feature_dim=x.shape[2], horizon=horizon,
            **cfg)
        self.forecaster.fit(x, y, batch_size=batch_size, epochs=epochs)
        return self

    def predict(self, x):
        if self.forecaster is None:
            raise RuntimeError("call fit() first")
        return self.scaler.inverse_transform_y(self.forecaster.predict(x))

    def evaluate(self, x, y):
        if self.forecaster is None:
            raise RuntimeError("call fit() first")
        return self.forecaster.evaluate(x, y)
