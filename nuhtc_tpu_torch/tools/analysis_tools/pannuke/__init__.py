"""The PanNuke metric suites: ``compute_stats`` (bPQ / mPQ per class and per
tissue) and ``compute_stats_all`` (DQ, precision, recall, TP/FP/FN and PQ per
class and tissue, by centroid or IoU matching)."""
