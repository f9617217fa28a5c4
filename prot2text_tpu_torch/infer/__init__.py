from .generate import GenerationConfig, run_generation
from .kvcache import init_kv_cache

__all__ = ["GenerationConfig", "init_kv_cache", "run_generation"]
