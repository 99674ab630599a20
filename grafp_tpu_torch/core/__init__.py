from grafp_tpu_torch.core.config import Config, config_from_dict, load_config, override
from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.core.mesh import DeviceMesh, make_mesh, db_mesh_from_config
