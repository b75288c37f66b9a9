from .logging import create_logger  # noqa: F401
from .seeds import set_random_seed  # noqa: F401
