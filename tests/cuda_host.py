"""Build a kernel source of surfjax_torch/kernels/csrc for the CPU, behind
the host stand-in of the CUDA runtime (tests/fixtures/cuda_host), so that
the CPU tests run the kernel's own code against its plain version.

The source's launches (`kernel<<<grid, block, smem, stream>>>(args)`)
become calls of cuda_host::launch, its `extern __shared__` arrays static
ones; g++ builds it with -ffp-contract=off (each multiply and add rounds
on its own, as nvcc's -fmad=false does) into a shared library with the
source's C interface."""

import ctypes
import os
import re
import shutil
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "surfjax_torch", "kernels", "csrc")
STUB = os.path.join(ROOT, "tests", "fixtures", "cuda_host")
SHARED_WORDS = 1 << 16   # size of a stand-in `extern __shared__` array


def host_source(text: str) -> str:
    """A CUDA source -> the same source for the host stand-in."""
    text = re.sub(r"([\w:]+(?:<[^;<>]*>)?)\s*<<<(.*?)>>>\s*\(",
                  r"cuda_host::launch(\1, \2, ", text, flags=re.S)
    return re.sub(r"extern __shared__ (.*?)\[\];",
                  rf"__shared__ \1[{SHARED_WORDS}];", text)


def gxx():
    return shutil.which("g++")


def build(source: str, out_dir: str) -> ctypes.CDLL:
    """Compile csrc/`source` for the host into out_dir -> the library. The
    headers of csrc are rewritten beside it, so that the source includes
    the rewritten ones."""
    for name in os.listdir(CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(CSRC, name)) as fh:
                text = host_source(fh.read())
            with open(os.path.join(out_dir, name), "w") as fh:
                fh.write(text)
    with open(os.path.join(CSRC, source)) as fh:
        text = host_source(fh.read())
    src = os.path.join(out_dir, source.replace(".cu", "_host.cpp"))
    with open(src, "w") as fh:
        fh.write(text)
    lib = src[:-4] + ".so"
    cmd = [gxx(), "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
           "-shared", "-pthread", "-I", STUB, "-I", out_dir, src, "-o", lib]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}:\n{proc.stderr}")
    return ctypes.CDLL(lib)
