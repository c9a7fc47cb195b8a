from .optimizer import OptConfig, adamw_update, init_opt_state
from .train_step import init_train_state, make_train_step
from .trainer import PreemptionError, TrainerConfig, train
