"""The host serde kernels (serde_kernels.cpp) and their ctypes bindings."""
