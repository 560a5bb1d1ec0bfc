from .kernels import GaussianKernel, KernelFamily

__all__ = ["GaussianKernel", "KernelFamily"]
