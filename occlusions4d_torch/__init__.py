'''
occlusions4d_torch: the PyTorch/CUDA port of occlusions4d_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package imports nothing of it. Plain
tensor code is PyTorch; every kernel the JAX package wrote in Pallas is a CUDA
C++ kernel under csrc/, built with nvcc at first use (ops/_build.py) and
called through ctypes. Each kernel has a plain PyTorch version beside it,
which runs for CPU tensors (the tests) and nowhere on a CUDA path.

Entry points take an explicit `device` (default 'cuda') and raise when CUDA is
asked for but absent; they never fall back to the CPU on their own.
'''

import shutil

__all__ = ['environment', 'resolve_device']


def environment():
    '''Probe of what this process can run: torch version, CUDA availability,
    device name and capability, and the nvcc the kernel build would use.'''
    import torch
    from .ops._build import nvcc_path
    cuda = torch.cuda.is_available()
    return dict(
        torch=torch.__version__,
        torch_cuda=torch.version.cuda,
        cuda_available=cuda,
        device_name=torch.cuda.get_device_name(0) if cuda else None,
        device_count=torch.cuda.device_count() if cuda else 0,
        capability=list(torch.cuda.get_device_capability(0)) if cuda else None,
        nvcc=nvcc_path(),
        nvidia_smi_path=shutil.which('nvidia-smi'),
    )


def resolve_device(device='cuda'):
    '''torch.device for an entry point; raises when CUDA is requested but
    unavailable (no silent CPU fallback).'''
    import torch
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA device requested but torch.cuda.is_available() '
                           'is False; pass device="cpu" to run the plain versions')
    return dev
