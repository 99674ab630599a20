from grafp_tpu_torch.train.loss import ntxent_loss
from grafp_tpu_torch.train.state import TrainState, cosine_epoch_schedule, create_train_state
from grafp_tpu_torch.train.step import make_train_step
