"""Hand-written Hopper kernels (CUDA C++, ``csrc/``) and their wrappers.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, under ``build/kernels/<hash
of the sources>/``, and loaded with ``ctypes``; ptxas's report of each
kernel's registers, shared memory and spills is kept beside it.  Nothing
is built or loaded when this module is imported, so it imports on a
machine without ``nvcc``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on the current stream, raises if the
launch reports an error, and adds one to its ``launches`` attribute.  The
wrappers take CUDA tensors only; the plain PyTorch versions live beside
their callers (``ops/targets.py``, ``ops/decode.py``,
``models/layers.py``), and those callers take them only for tensors on the
CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("heatmap.cu", "decode.cu", "bn_act.cu")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_PTXAS_REPORT = "ptxas.txt"  # each kernel's registers, shared memory, spills

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc_candidates() -> List[str]:
    out = []
    if os.environ.get("CUDA_HOME"):
        out.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    out.append("/usr/local/cuda/bin/nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        out.append(on_path)
    return out


def find_nvcc() -> str:
    for path in _nvcc_candidates():
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from "
        f"{_CSRC} with nvcc at first use")


def _run(procs: List[Tuple[List[str], subprocess.Popen]]) -> str:
    """Wait for every command; raise with their errors if any failed, else
    return what they wrote to stderr."""
    errors, logs = [], []
    for cmd, proc in procs:
        _, err = proc.communicate()
        err = err.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{err}")
        logs.append(err)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return "".join(logs)


def _build(out_dir: Path) -> Path:
    """Compile every source in parallel (one nvcc each), then link."""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"tmp.{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    objs, procs = [], []
    for name in _SOURCES:
        obj = tmp / (name + ".o")
        cmd = [nvcc, *_NVCC_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                            stderr=subprocess.PIPE)))
        objs.append(str(obj))
    (out_dir / _PTXAS_REPORT).write_text(_run(procs))
    so_tmp = tmp / "libpose_kernels.so"
    cmd = [nvcc, *_NVCC_FLAGS, "-shared", *objs, "-o", str(so_tmp)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE))])
    so = out_dir / "libpose_kernels.so"
    os.replace(so_tmp, so)  # atomic: a concurrent build sees all or none
    shutil.rmtree(tmp, ignore_errors=True)
    return so


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> float:
    """Build (if needed) and load the kernel library; returns the seconds
    spent, 0 when it was already loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return 0.0
        t0 = time.perf_counter()
        so = _BUILD_ROOT / _source_hash() / "libpose_kernels.so"
        if not so.exists():
            so = _build(so.parent)
        lib = ctypes.CDLL(str(so))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sbp_heatmaps_launch.argtypes = [vp, vp, ci, ci, ci, cf, cf, cf,
                                            vp]
        lib.sbp_heatmaps_launch.restype = ci
        lib.decode_sbp_launch.argtypes = [vp, vp, ci, ci, ci, cf, cf, ci, vp]
        lib.decode_sbp_launch.restype = ci
        plan = ctypes.POINTER(ci)
        lib.bn_act_forward_launch.argtypes = [plan] + [vp] * 9 + [ci, cf, cf,
                                                                  vp]
        lib.bn_act_forward_launch.restype = ci
        lib.bn_act_backward_launch.argtypes = [plan] + [vp] * 7 + [ci, vp]
        lib.bn_act_backward_launch.restype = ci
        _lib = lib
        return time.perf_counter() - t0


def ptxas_report() -> List[str]:
    """The ptxas lines of the loaded build: per kernel, its registers,
    shared memory and spills (``-Xptxas -v``)."""
    path = _BUILD_ROOT / _source_hash() / _PTXAS_REPORT
    lines = path.read_text().splitlines() if path.exists() else []
    return [ln.strip() for ln in lines
            if "entry function" in ln or "Used" in ln or "spill" in ln]


def _check(t: torch.Tensor, name: str, ndim: int, last: Optional[int] = None,
           dtype: torch.dtype = torch.float32) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements, too many for "
                         "the kernel's 32-bit indexing")


def _raise_on(code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code}")


def sbp_heatmaps_cuda(joints: torch.Tensor, output_res: Tuple[int, int],
                      sigma: float) -> torch.Tensor:
    """K1: joints [B, K, 2] fp32 (output-map px, negative = invisible) ->
    Gaussian heatmaps [B, K, H, W] fp32.  The kernel writes 16-byte
    vectors when (H*W) % 4 == 0 (every map then starts 16-byte aligned),
    else single floats."""
    _check(joints, "joints", 3, 2)
    h, w = int(output_res[0]), int(output_res[1])
    if h <= 0 or w <= 0:
        raise ValueError(f"output_res must be positive, got {output_res}")
    b, k, _ = joints.shape
    out = torch.empty((b, k, h, w), dtype=torch.float32,
                      device=joints.device)
    if out.numel() >= 2 ** 31:
        raise ValueError("heatmaps too large for the kernel's indexing")
    build_kernels()
    sigma = float(sigma)
    with torch.cuda.device(joints.device):
        stream = torch.cuda.current_stream(joints.device).cuda_stream
        code = _lib.sbp_heatmaps_launch(
            joints.data_ptr(), out.data_ptr(), b * k, h, w, 3 * sigma,
            3 * sigma + 1, 2.0 * sigma * sigma, stream)
    _raise_on(code, "sbp_heatmaps")
    sbp_heatmaps_cuda.launches += 1
    return out


sbp_heatmaps_cuda.launches = 0


def decode_sbp_cuda(logits: torch.Tensor, input_w: int,
                    conf_threshold: float, pred: bool = True
                    ) -> torch.Tensor:
    """K2: logits [B, K, H, W] fp32 -> joints [B, K, 3] (x, y, conf) in
    input pixels, sentinel (-s, -s, -1) where the peak does not clear
    ``conf_threshold``.  The kernel reads 16-byte vectors when every map
    starts on a 16-byte boundary, else single floats."""
    _check(logits, "logits", 4)
    b, k, h, w = logits.shape
    if h * w == 0:
        raise ValueError(f"logits has empty maps: {tuple(logits.shape)}")
    out = torch.empty((b, k, 3), dtype=torch.float32, device=logits.device)
    build_kernels()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        code = _lib.decode_sbp_launch(
            logits.data_ptr(), out.data_ptr(), b * k, h * w, w,
            int(input_w) / w, float(conf_threshold), int(bool(pred)), stream)
    _raise_on(code, "decode_sbp")
    decode_sbp_cuda.launches += 1
    return out


decode_sbp_cuda.launches = 0

KERNELS = (sbp_heatmaps_cuda, decode_sbp_cuda)

# K3's tiling (csrc/bn_act.cu): at most 256 threads a block, a position of
# 8 bf16 (one 16-byte vector) or 1 a thread; about two waves of 8 blocks
# on each of the card's SMs; at least 4 images a block, one load each in
# flight per thread.
_BN_THREADS = 256
_BN_BLOCKS_PER_SM = 2 * 8
_BN_MIN_IMAGES = 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class BnPlan(NamedTuple):
    """K3's tiling of an [n, c, hw] activation: a tile is ``cpt`` whole
    channels of one image (small planes), or one of ``segs`` segments of
    ``seg_len`` elements of a channel's plane (large planes, ``cpt`` 1);
    a block takes one tile for ``ipb`` images, ``splits`` blocks a tile;
    ``threads`` a block, one position of 8 elements (``vec``) or 1 each."""
    n: int
    c: int
    hw: int
    cpt: int
    segs: int
    seg_len: int
    splits: int
    ipb: int
    threads: int
    vec: int

    @property
    def parts(self) -> int:
        """Partials a channel: one a segment and image range."""
        return self.segs * self.splits


def bn_plan(n: int, c: int, hw: int, vec: bool, sms: int) -> BnPlan:
    """K3's tiling for ``n`` images of ``c`` channels of ``hw`` pixels on a
    card of ``sms`` SMs; ``vec``: 16-byte vectors (hw % 8 == 0 and aligned
    pointers)."""
    v = 8 if vec else 1
    span = _BN_THREADS * v
    if hw > span:
        segs = _ceil(hw, span)
        seg_len, cpt = _ceil(_ceil(hw, segs), v) * v, 1
    else:
        segs, seg_len, cpt = 1, hw, min(c, span // hw)
    threads = _ceil(cpt * seg_len // v, 32) * 32
    tiles = _ceil(c, cpt) * segs
    splits = max(1, min(_ceil(n, _BN_MIN_IMAGES),
                        _ceil(_BN_BLOCKS_PER_SM * sms, tiles)))
    ipb = _ceil(n, splits)
    return BnPlan(n, c, hw, cpt, segs, seg_len, _ceil(n, ipb), ipb, threads,
                  int(vec))


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_arg(plan: BnPlan):
    return (ctypes.c_int * len(plan))(*plan)


def _check_channels(c: int, device, **tensors) -> None:
    for name, t in tensors.items():
        _check(t, name, 1, c)
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the input on "
                             f"{device}")


def bn_act_forward_cuda(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, running_mean: torch.Tensor,
                        running_var: torch.Tensor,
                        num_batches_tracked: torch.Tensor, momentum: float,
                        eps: float, relu: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 forward, train-mode BatchNorm (+ ReLU): x [N, C, H, W] bf16 ->
    (y [N, C, H, W] bf16, stats [4, C] fp32: mean, invstd, scale, shift).
    Updates ``running_mean`` and ``running_var`` in place by flax's rule
    with the biased batch variance and adds one to
    ``num_batches_tracked``."""
    _check(x, "x", 4, dtype=torch.bfloat16)
    n, c, h, w = x.shape
    if n * h * w < 2:
        raise ValueError("BatchNorm needs more than one value per channel "
                         f"in train mode, got input {tuple(x.shape)}")
    _check_channels(c, x.device, weight=weight, bias=bias,
                    running_mean=running_mean, running_var=running_var)
    nbt = num_batches_tracked
    if nbt.device != x.device or nbt.dtype != torch.int64 or \
            nbt.numel() != 1:
        raise ValueError("num_batches_tracked must be one int64 on "
                         f"{x.device}, got {nbt.dtype} {tuple(nbt.shape)} "
                         f"on {nbt.device}")
    y = torch.empty_like(x)
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    plan = bn_plan(n, c, h * w, (h * w) % 8 == 0 and
                   x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0,
                   _sm_count(x.device))
    scratch = torch.empty(3 * c * plan.parts, dtype=torch.float32,
                          device=x.device)
    build_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _lib.bn_act_forward_launch(
            _plan_arg(plan), x.data_ptr(), y.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), nbt.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), int(bool(relu)), float(momentum), float(eps),
            stream)
    _raise_on(code, "bn_act_forward")
    bn_act_forward_cuda.launches += 1
    return y, stats


bn_act_forward_cuda.launches = 0


def bn_act_backward_cuda(dy: torch.Tensor, x: torch.Tensor,
                         stats: torch.Tensor, relu: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 backward: dy, x [N, C, H, W] bf16 and the forward's ``stats`` ->
    (dx bf16, dweight [C] fp32, dbias [C] fp32)."""
    _check(x, "x", 4, dtype=torch.bfloat16)
    _check(dy, "dy", 4, dtype=torch.bfloat16)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    n, c, h, w = x.shape
    _check(stats, "stats", 2, c)
    if stats.shape[0] != 4 or stats.device != x.device:
        raise ValueError(f"stats must be [4, {c}] on {x.device}, got "
                         f"{tuple(stats.shape)} on {stats.device}")
    dx = torch.empty_like(x)
    dweight = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    plan = bn_plan(n, c, h * w, (h * w) % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (dy, x, dx)), _sm_count(x.device))
    scratch = torch.empty(2 * c * plan.parts + 2 * c, dtype=torch.float32,
                          device=x.device)
    build_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _lib.bn_act_backward_launch(
            _plan_arg(plan), dy.data_ptr(), x.data_ptr(), stats.data_ptr(),
            dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
            scratch.data_ptr(), int(bool(relu)), stream)
    _raise_on(code, "bn_act_backward")
    bn_act_backward_cuda.launches += 1
    return dx, dweight, dbias


bn_act_backward_cuda.launches = 0
