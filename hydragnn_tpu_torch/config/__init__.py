from .config import (HeadConfig, ModelConfig, build_model_config,
                     gather_deg, get_log_name_config, load_config,
                     update_config)

__all__ = ["HeadConfig", "ModelConfig", "build_model_config", "gather_deg",
           "get_log_name_config", "load_config", "update_config"]
