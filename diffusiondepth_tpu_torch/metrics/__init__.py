from .depth_metrics import METRIC_NAMES, DepthMetric, evaluate_depth_metrics, get_metric

__all__ = ["METRIC_NAMES", "DepthMetric", "evaluate_depth_metrics", "get_metric"]
