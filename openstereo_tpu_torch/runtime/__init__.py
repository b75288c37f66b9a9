from .optim import build_optimizer, build_schedule  # noqa: F401
from .train_state import TrainState  # noqa: F401
from .trainer import Trainer  # noqa: F401
