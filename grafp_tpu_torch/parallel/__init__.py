from grafp_tpu_torch.parallel.distributed import (
    hybrid_mesh,
    initialize_distributed,
    retrieval_mesh,
    training_mesh,
)
