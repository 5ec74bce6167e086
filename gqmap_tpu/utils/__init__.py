from .cache import enable_compile_cache
from .checkpoint import save_checkpoint, load_checkpoint
