"""Build and bind the hand-written CUDA kernels.

The sources in `csrc/` are compiled by `nvcc` into one shared library with
a plain C interface (no PyTorch headers) and loaded with ctypes: one nvcc
per source, all started together, then one link. Every source is built
with -fmad=false (each multiply and add rounds on its own, as in the plain
versions) but the roofline probe's contracted twin, which exists to price
exactly that flag. The library is built at
first use into `build/surfjax_torch/` at the root of the checkout, keyed
by a hash of the sources and the flags, and written to a per-process temp
file that is renamed into place, so concurrent builders never load a
partial file. A failed build or load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "surfjax_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
                     "-fPIC")
NO_FMA = ("-fmad=false",)
# source -> the flags it gets beside NVCC_FLAGS
SOURCES = {"frame_fused.cu": NO_FMA, "kf_staged.cu": NO_FMA,
           "kf_frame_prof.cu": NO_FMA, "split_path.cu": NO_FMA,
           "split_staged.cu": NO_FMA, "ao_fix_staged.cu": NO_FMA,
           "ao_fix_crowd.cu": NO_FMA,
           "mesh_tile.cu": NO_FMA, "mesh_candidates.cu": NO_FMA,
           "prime_tile.cu": NO_FMA,
           "fp32_peak.cu": NO_FMA, "fp32_peak_fma.cu": ("-fmad=true",)}
# the KF_WIDE builds of the kernels that take SDF and analytic objects
# (csrc/frame_fused.cuh), for scenes past their per-thread arrays; their C
# entries are WIDE_ENTRIES' names with _wide at the end
WIDE_ENTRIES = ("kf_frame_fused", "ks_frame_fused", "ks_occupancy",
                "sp_render_tile", "sp_trace_rays", "sp_ao_fix",
                "sp_staged_render_tile", "sp_staged_trace_rays",
                "sp_staged_ao_fix", "pt_prime_tile", "pt_occupancy")
SOURCES.update({name.replace(".cu", "_wide.cu"): NO_FMA for name in (
    "frame_fused.cu", "kf_staged.cu", "split_path.cu", "split_staged.cu",
    "ao_fix_staged.cu", "ao_fix_crowd.cu", "prime_tile.cu")})


def _source_files():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256(repr((NVCC_FLAGS, sorted(SOURCES.items()))).encode())
    for path in _source_files():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source at first use")


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libsurfjax_kernels_{source_hash()}.so")


def build() -> dict:
    """Compile the library unless it is already built.

    -> {"path", "built" (bool), "seconds", "log" (nvcc's -Xptxas -v
    report: registers, stack and spills per kernel)}."""
    out = library_path()
    log_path = out[:-3] + ".log"
    if os.path.exists(out):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as fh:
                log = fh.read()
        return {"path": out, "built": False, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src, extra in SOURCES.items():
        obj = f"{tmp}.{src[:-3]}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-I", CSRC, "-o", obj,
               os.path.join(CSRC, src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (rc {proc.returncode}):\n{text}")
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", f"{tmp}.so", *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (rc {proc.returncode}):\n"
                          f"{logs[-1]}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    log = "".join(logs)
    with open(log_path, "w") as fh:
        fh.write(log)
    os.replace(f"{tmp}.so", out)
    return {"path": out, "built": True, "seconds": seconds, "log": log}


def entries(log: str) -> dict:
    """build()'s log -> {kernel entry: (its stack and spill line, its
    registers line)} from ptxas' report."""
    lines = [ln.split("info    :", 1)[-1].strip() for ln in log.splitlines()]
    out = {}
    for k, ln in enumerate(lines):
        m = re.match(r"Compiling entry function '(\w+)'", ln)
        if m and lines[k + 1] == f"Function properties for {m.group(1)}":
            out[m.group(1)] = (lines[k + 2], lines[k + 3])
    return out


def sass_hashes(lib_path: str, names) -> dict:
    """-> {entry: the first 16 hex digits of the sha256 of its SASS, as
    cuobjdump prints it} (empty where the toolkit has no cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return {}
    out = {}
    for name in names:
        res = subprocess.run([tool, "-sass", "-fun", name, lib_path],
                             capture_output=True, text=True, timeout=300)
        body = [ln for ln in res.stdout.splitlines() if "/*" in ln]
        out[name] = hashlib.sha256("\n".join(body).encode()).hexdigest()[:16] \
            if body else None
    return out


# sass_loops' instruction classes: by default the kinds of work it counts
LOOP_CLASSES = {"fp32": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL",
                         "MUFU"),
                "shared": ("LDS",), "global": ("LDG", "LD."),
                "shuffle": ("SHFL", "VOTE")}
# ... or by the pipe that issues them (compute capability 9.0): FP32 add,
# multiply and FMA; the multi-function unit (reciprocal, reciprocal square
# root); compares, min, max and selects; integer arithmetic and logic;
# branches and calls; whatever is left counts in "instructions" only
PIPE_CLASSES = {"fp32": ("FADD", "FMUL", "FFMA"), "mufu": ("MUFU",),
                "compare": ("FSETP", "FMNMX", "FSEL", "FCHK", "FSET",
                            "ISETP", "IMNMX", "SEL", "PLOP3", "P2R", "R2P"),
                "integer": ("IADD", "IMAD", "LOP", "SHF", "LEA", "IABS",
                            "FLO", "POPC", "PRMT", "BMSK", "I2F", "F2I"),
                "branch": ("BRA", "BRX", "BSSY", "BSYNC", "CALL", "RET",
                           "EXIT", "WARPSYNC", "BREAK", "JMP", "YIELD")}


def _sass_code(lines) -> list:
    code = []
    for ln in lines:
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m:
            code.append((int(m.group(1), 16), m.group(2)))
    return code


def _cuobjdump(lib_path: str, fun: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", "-fun", fun, lib_path],
                          capture_output=True, text=True,
                          timeout=300).stdout


def sass_of_many(lib_path: str, names) -> dict:
    """-> {entry: its SASS as (address, text) per instruction} for several
    entries, from one cuobjdump call that takes their names as one comma
    list (an entry that stands in several of the library's units has the
    SASS of each, one after the other)."""
    out, cur = {}, None
    for ln in _cuobjdump(lib_path, ",".join(names)).splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(ln)
    return {name: _sass_code(out.get(name, ())) for name in names}


def sass_of(lib_path: str, name: str) -> list:
    """-> one entry's SASS, as cuobjdump prints it: (address, text) per
    instruction."""
    return sass_of_many(lib_path, [name])[name]


def opcode(text: str) -> str:
    """An instruction's opcode, its predicate guard dropped."""
    return text.split()[1] if text.startswith("@") else text.split()[0]


def sass_loops(lib_path: str, name: str, classes=None, code=None) -> list:
    """-> the loops of one entry's SASS (`code`, or sass_of's): for each
    backward branch, {"start", "end" (its addresses), "instructions" (in
    [start, end]), and the count of each class of `classes` (by default
    LOOP_CLASSES)}, innermost first (fewest instructions)."""
    if code is None:
        code = sass_of(lib_path, name)
    classes = LOOP_CLASSES if classes is None else classes
    loops = []
    for addr, text in code:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) > addr:
            continue
        start = int(m.group(1), 16)
        ops = [opcode(t) for a, t in code if start <= a <= addr]
        loop = {"start": hex(start), "end": hex(addr),
                "instructions": len(ops)}
        for cls, names in classes.items():
            loop[cls] = sum(op.startswith(names) for op in ops)
        loops.append(loop)
    return sorted(loops, key=lambda lp: lp["instructions"])


def sass_counts(lib_path: str, name: str) -> dict:
    """-> the local loads and stores (LDL, STL: the thread's stack frame
    and spills) in one entry's SASS, as cuobjdump prints it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", "-fun", name, lib_path],
                         capture_output=True, text=True, timeout=300)
    out = {"LDL": 0, "STL": 0}
    for ln in res.stdout.splitlines():
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      ln)
        if m and m.group(1) in out:
            out[m.group(1)] += 1
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    from surfjax_torch.kernels.mesh_tile import (
        McArgs, MeshTileArgs, MeshTileProf,
    )
    from surfjax_torch.kernels.render_tile import (
        KFSettings, KFTables, KSLayout, PrimeArgs, SplitRays,
    )
    lib = ctypes.CDLL(build()["path"])
    lib.kf_frame_fused.argtypes = [KFTables, KFSettings, ctypes.c_int,
                                   ctypes.c_void_p]
    # tables, settings, layout, profile counters or null, tile counter,
    # device, stream
    lib.ks_frame_fused.argtypes = [KFTables, KFSettings, KSLayout,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p]
    # tables, settings, profile counters, device, stream
    lib.kf_frame_profile.argtypes = [KFTables, KFSettings, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.ks_occupancy.argtypes = [KSLayout, ctypes.POINTER(ctypes.c_int)]
    for name in ("sp_render_tile", "sp_trace_rays"):
        getattr(lib, name).argtypes = [KFTables, KFSettings, SplitRays,
                                       ctypes.c_int, ctypes.c_void_p]
    # tables, settings, (K2: layout,) rays, profile counters or null, (K2:
    # the two work counters,) device, stream; ao_fix (with a crowd:
    # sp_ao_fix) as K1
    for name in ("sp_staged_render_tile", "sp_staged_ao_fix", "sp_ao_fix"):
        getattr(lib, name).argtypes = [KFTables, KFSettings, SplitRays,
                                       ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.sp_staged_trace_rays.argtypes = [KFTables, KFSettings, KSLayout,
                                         SplitRays, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p]
    # tables, settings, layout, coarse rays, profile counters or null,
    # device, stream
    lib.pt_prime_tile.argtypes = [KFTables, KFSettings, KSLayout, PrimeArgs,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.pt_occupancy.argtypes = [KSLayout, ctypes.POINTER(ctypes.c_int)]
    lib.mt_mesh_tile.argtypes = [MeshTileArgs, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.mt_mesh_tile_profile.argtypes = [MeshTileArgs, MeshTileProf,
                                         ctypes.c_int, ctypes.c_void_p]
    lib.mc_candidates.argtypes = [McArgs, ctypes.c_int, ctypes.c_void_p]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fma in ("", "_fma"):
        # cheb, px, py, pz, out, profile records or null, n, iters, unroll,
        # device, stream
        getattr(lib, "fp_mix" + fma).argtypes = [i32] + [ptr] * 5 + [
            i32] * 4 + [ptr]
        # cheb, unroll, prof, device, blocks per SM
        getattr(lib, "fp_mix_occupancy" + fma).argtypes = [i32] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
    mixes = ("fp_mix", "fp_mix_fma", "fp_mix_occupancy",
             "fp_mix_occupancy_fma")
    # a, out, n, iters, chains per thread, device, stream
    lib.fp_fma_dep.argtypes = [ptr] * 2 + [i32] * 4 + [ptr]
    for name in ("kf_frame_fused", "ks_frame_fused", "kf_frame_profile",
                 "ks_occupancy", "sp_render_tile", "sp_trace_rays",
                 "sp_ao_fix", "sp_staged_render_tile",
                 "sp_staged_trace_rays", "sp_staged_ao_fix",
                 "pt_prime_tile", "pt_occupancy",
                 "mt_mesh_tile",
                 "mt_mesh_tile_profile", "mc_candidates", "fp_fma_dep",
                 *mixes):
        getattr(lib, name).restype = ctypes.c_int
    lib.kf_error_string.argtypes = [ctypes.c_int]
    lib.kf_error_string.restype = ctypes.c_char_p
    # each entry's KF_WIDE build (csrc/*_wide.cu) takes the same arguments
    for name in WIDE_ENTRIES:
        wide = getattr(lib, name + "_wide")
        wide.argtypes = getattr(lib, name).argtypes
        wide.restype = ctypes.c_int
    return lib


def error_string(err: int) -> str:
    return load().kf_error_string(err).decode()
