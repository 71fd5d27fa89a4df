"""The analysis command lines of the port (tools/analysis_tools of the JAX
package), each run as ``python -m nuhtc_tpu_torch.tools.analysis_tools.<name>``
with the JAX script's arguments: ``eval_metric``, ``print_metric``,
``print_metric_all``, ``confusion_matrix``, ``coco_error_analysis``,
``analyze_results``, ``interrater_analysis``, ``robustness_eval``,
``test_robustness`` (it runs the detector; ``--device``),
``viz_utils`` and the per-dataset suites ``pannuke.compute_stats``,
``pannuke.compute_stats_all``, ``conic.compute_stats`` and
``consep.compute_stats``; and the benchmark tools ``benchmark``,
``benchmark_wsi``, ``benchmark_train`` and ``get_flops`` (``--device``).

matplotlib draws the figures of ``confusion_matrix`` and
``coco_error_analysis``; it is imported only where a figure is drawn, after
every numeric output is written, and a missing matplotlib raises ImportError
by name (``pyplot``)."""

from __future__ import annotations


def pyplot(what: str):
    """matplotlib's pyplot on the Agg backend, for ``what``; ImportError
    naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{what} needs matplotlib, which is not installed "
                          "(the numeric outputs are written)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_test_dataset(config: str, cfg_options=None):
    """The config's test split (``test_mode``), with ``key=value`` overrides."""
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.coco import build_dataset

    cfg = Config.fromfile(config)
    if cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in cfg_options))
    return cfg, build_dataset({**cfg.data.test, "test_mode": True})
