"""Native host runtime (ctypes) and the CUDA kernel build/launch layer."""
