from grafp_tpu_torch.models.ast import ASTEncoder
from grafp_tpu_torch.models.gnn import FFN, Downsample, GraphEncoder, Grapher
from grafp_tpu_torch.models.nafp import NAFPEncoder
from grafp_tpu_torch.models.peak_embed import PeakEmbed
from grafp_tpu_torch.models.simclr import Projector, SimCLRModel, build_model
