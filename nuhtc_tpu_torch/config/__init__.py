from nuhtc_tpu_torch.config.config import Config, ConfigDict, resolve_vars

__all__ = ["Config", "ConfigDict", "resolve_vars"]
