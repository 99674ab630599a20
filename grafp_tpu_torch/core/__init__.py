from grafp_tpu_torch.core.config import Config, config_from_dict, load_config, override
from grafp_tpu_torch.core.device import resolve_device
