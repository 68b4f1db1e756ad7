from admmnet_tpu.utils.compile_cache import enable_compile_cache

__all__ = ["enable_compile_cache"]
