from .anomaly_detector import AnomalyDetector, FeatureLabelIndex

__all__ = ["AnomalyDetector", "FeatureLabelIndex"]
