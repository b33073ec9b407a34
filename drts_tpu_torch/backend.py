"""Device choice and the CUDA kernel library of the port.

Device: every builder takes an explicit ``device``; ``device()`` turns a
name into a ``torch.device`` and refuses ``cuda`` where no card is present
(there is no silent fallback to the CPU).

Kernels: the CUDA C++ sources under ``csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface (``build/libdrts_kernels_<key>.so``, git-ignored), loaded with
``ctypes``. The key hashes the nvcc flags and the resolved nvcc path, so a
change to either builds a new library; the build takes seconds and is also
redone when a source or header is newer than the library. Each source
compiles to its own object file, all at once, and one link makes the
library.

Launch counts: ``LAUNCHES`` holds one count per kernel wrapper
(``ops/intersect_kernels.py``, ``ops/restir_kernels.py``,
``ops/reproject_kernels.py``, ``ops/trimesh_kernels.py``), keyed by the
wrapper's name. A wrapper calls ``launched(name)`` where it launches its
kernel, and nowhere else; ``reset_launches`` zeroes them all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
SOURCES = ("intersect.cu", "restir.cu", "reproject.cu", "trimesh.cu")
HEADERS = ("rays.cuh",)   # included by intersect.cu and trimesh.cu
# -fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch versions compute them; no --use_fast_math (IEEE sqrt, NaN kept).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# C signatures of csrc/*.cu: every pointer and the stream as void*.
_SIGNATURES = {
    # rays, n, table, cols, bounds, n_chunks, cull_scale, pos_bits, t_out,
    # obj_out, stream
    "drts_morton_closest_hit": (_VOIDP, _INT, _VOIDP, _INT, _VOIDP, _INT,
                                _FLOAT, _INT, _VOIDP, _VOIDP, _VOIDP),
    "drts_brute_closest_hit": (_VOIDP, _INT, _VOIDP, _INT, _VOIDP, _VOIDP,
                               _VOIDP),
    # rays, n, table, cols, bounds, n_chunks, mxu_a, parts (the
    # precision's bf16 parts: 1, 2, 3), cull_scale, pos_bits, t_out,
    # obj_out, stream
    "drts_morton_mxu_closest_hit": (_VOIDP, _INT, _VOIDP, _INT, _VOIDP,
                                    _INT, _VOIDP, _INT, _FLOAT, _INT,
                                    _VOIDP, _VOIDP, _VOIDP),
    # rays, n, table, cols, bounds, n_chunks, mxu_a, parts, cull_scale,
    # occ_out, stream
    "drts_morton_mxu_occlusion": (_VOIDP, _INT, _VOIDP, _INT, _VOIDP, _INT,
                                  _VOIDP, _INT, _FLOAT, _VOIDP, _VOIDP),
    # cols, n_chunks, n, parts, out (7 ints)
    "drts_morton_mxu_closest_hit_info": (_INT, _INT, _INT, _INT, _VOIDP),
    "drts_morton_mxu_occlusion_info": (_INT, _INT, _INT, _INT, _VOIDP),
    # rays, n, bounds_tbl, c_pad, members_tbl, n_clusters, max_members,
    # t_out, obj_out, stream
    "drts_clustered_closest_hit": (_VOIDP, _INT, _VOIDP, _INT, _VOIDP, _INT,
                                   _INT, _VOIDP, _VOIDP, _VOIDP),
    # n_clusters, max_members, n, out (7 ints)
    "drts_clustered_closest_hit_info": (_INT, _INT, _INT, _VOIDP),
    # rays, n, table, cols, bounds, n_chunks, cull_scale, occ_out, stream
    "drts_morton_occlusion": (_VOIDP, _INT, _VOIDP, _INT, _VOIDP, _INT,
                              _FLOAT, _VOIDP, _VOIDP),
    # surf, uni, slots, n, table, n_lights, n_l, s, n_b, out_f, out_i, stream
    "drts_initial_light_candidates": (_VOIDP, _VOIDP, _VOIDP, _INT, _VOIDP,
                                      _INT, _INT, _INT, _INT, _VOIDP,
                                      _VOIDP, _VOIDP),
    # n_lights, s, out (5 ints)
    "drts_initial_light_candidates_info": (_INT, _INT, _VOIDP),
    # src, motion, h, src_h, row0, w, c, bilinear, vec, out, ok, stream
    "drts_reproject": (_VOIDP, _VOIDP, _INT, _INT, _INT, _INT, _INT, _INT,
                       _INT, _VOIDP, _VOIDP, _VOIDP),
    # rays, n, cursor, table, m_tbl, inst_bounds, ic_cols, inst_chunk,
    # cull_scale, pos_bits, key_out, stream
    "drts_bound_scan": (_VOIDP, _INT, _VOIDP, _VOIDP, _INT, _VOIDP, _INT,
                        _INT, _FLOAT, _INT, _VOIDP, _VOIDP),
    # rays, n, cand, best_in, binst_in, inst_tbl, m_tbl, tri_tbl, f_pad,
    # pos_bits, tri_bounds, tb_cols, chunk, tri_scale, guard, best_out,
    # binst_out, stream
    "drts_shared_blas_sweep": (_VOIDP, _INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                               _INT, _VOIDP, _INT, _INT, _VOIDP, _INT, _INT,
                               _FLOAT, _FLOAT, _VOIDP, _VOIDP, _VOIDP),
    # rays, n, inst_tbl, m_tbl, inst_bounds, ic_cols, n_ichunks, inst_chunk,
    # bound_scale, bound_pad, tri_tbl, f_pad, pos_bits, tri_bounds, tb_cols,
    # chunk, tri_scale, guard, image, t_out, face_out, inst_out, stream
    "drts_mesh_instances_closest": (_VOIDP, _INT, _VOIDP, _INT, _VOIDP, _INT,
                                    _INT, _INT, _FLOAT, _FLOAT, _VOIDP, _INT,
                                    _INT, _VOIDP, _INT, _INT, _FLOAT, _FLOAT,
                                    _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP),
    # rays, n, cand, occ_in, inst_tbl, m_tbl, tri_tbl, f_pad, tri_bounds,
    # tb_cols, chunk, tri_scale, guard, occ_out, stream
    "drts_shared_blas_any": (_VOIDP, _INT, _VOIDP, _VOIDP, _VOIDP, _INT,
                             _VOIDP, _INT, _VOIDP, _INT, _INT, _FLOAT,
                             _FLOAT, _VOIDP, _VOIDP),
    # rays, n, inst_tbl, m_tbl, inst_bounds, ic_cols, n_ichunks, inst_chunk,
    # bound_scale, bound_pad, tri_tbl, f_pad, tri_bounds, tb_cols, chunk,
    # tri_scale, guard, sparse_below, occ_out, stream
    "drts_mesh_instances_any": (_VOIDP, _INT, _VOIDP, _INT, _VOIDP, _INT,
                                _INT, _INT, _FLOAT, _FLOAT, _VOIDP, _INT,
                                _VOIDP, _INT, _INT, _FLOAT, _FLOAT, _INT,
                                _VOIDP, _VOIDP),
    # rays, n, bscan, m_pad, bs_pos_bits, inst_tbl, m_tbl, inst_bounds,
    # ic_cols, inst_chunk, tri_tbl, f_pad, pos_bits, tri_bounds, tb_cols,
    # tri_chunk, scan_scale, tri_scale, guard, rounds, best_out, binst_out,
    # key_out, stream
    "drts_cand_fused": (_VOIDP, _INT, _VOIDP, _INT, _INT, _VOIDP, _INT,
                        _VOIDP, _INT, _INT, _VOIDP, _INT, _INT, _VOIDP, _INT,
                        _INT, _FLOAT, _FLOAT, _FLOAT, _INT, _VOIDP, _VOIDP,
                        _VOIDP, _VOIDP),
}

_lib = None
LAUNCHES = dict.fromkeys(("intersect_morton", "intersect_brute",
                          "occlusion_morton", "initial_light_candidates",
                          "reproject_packed", "bound_scan",
                          "shared_blas_sweep", "intersect_mesh_instances",
                          "shared_blas_any",
                          "intersect_mesh_instances_any", "cand_fused",
                          "intersect_morton_mxu", "occlusion_morton_mxu",
                          "intersect_clustered"), 0)


def launched(name: str) -> None:
    """Count one launch of the kernel behind wrapper `name`."""
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def device(name: str = "cuda") -> torch.device:
    """The explicit device choice: raises for a CUDA device when PyTorch
    sees no card."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but PyTorch sees "
                           "no GPU")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(nvcc: str) -> str:
    """The library built by `nvcc` with NVCC_FLAGS."""
    key = hashlib.sha256(
        "\0".join((os.path.realpath(nvcc), *NVCC_FLAGS)).encode()
    ).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libdrts_kernels_{key}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/ unless its library (see lib_path) is newer than every
    source and header: one nvcc per source, all started together, then one
    link. Returns the library's path. With verbose, prints ptxas
    register/spill usage."""
    sources = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    nvcc = _nvcc()
    path = lib_path(nvcc)
    inputs = sources + [os.path.join(CSRC_DIR, h) for h in HEADERS]
    if os.path.exists(path) and not verbose and all(
            os.path.getmtime(s) <= os.path.getmtime(path) for s in inputs):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        ptxas = ("-Xptxas", "-v") if verbose else ()
        jobs = []
        for src in sources:
            obj = os.path.join(tmp_dir, os.path.basename(src) + ".o")
            cmd = [nvcc, *compile_flags, *ptxas, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
            logs.append(out)
        tmp = os.path.join(tmp_dir, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if verbose:
            print("".join(logs), flush=True)
        os.replace(tmp, path)   # atomic: concurrent builders never race
    return path


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream
