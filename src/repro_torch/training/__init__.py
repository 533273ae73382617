from .optimizer import AdamWConfig, init_opt_state, adamw_update, schedule
from .train_loop import make_train_step, init_train_state
from .checkpoint import save_checkpoint, load_checkpoint
