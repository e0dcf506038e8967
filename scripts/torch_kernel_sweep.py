#!/usr/bin/env python3
"""Time other tile and occupancy plans of the flash forward (K4) and the
catalog query gradient (K8) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and ``nvcc``::

    python3 scripts/torch_kernel_sweep.py

It compiles ``recstudio_torch/csrc/flash_attention.cu`` and ``softmax_z.cu``
once more, each with launchers of other plans of the same kernels
(``build/recstudio_torch/sweep/``), and a copy of the former whose K4 grid
runs the last query tiles first (under the causal mask they stream the most
key tiles). Each plan is timed with CUDA events at the
shapes ``chip_smoke.py`` uses (K4: phase H's B 256, H 2, L 1024, Dh 64,
causal, right padding, example 0 fully padded, and the Dh 32 ``odd`` row;
K8: phase F's M 51,200, N 3,706, D 64, and M 512, N 500,000) and held to the
shipped kernel's output. Prints the compilers' register report for the
sweep's kernels, one ``PLAN`` JSON line per plan, and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# K4 plans: (query rows / 16, keys / 16, accumulator columns / 16, blocks an SM)
K4_PLANS = [(4, 4, 4, 3), (4, 4, 4, 2), (4, 4, 4, 1), (4, 2, 4, 4), (4, 2, 4, 3), (2, 4, 4, 4),
            (2, 2, 4, 4), (4, 4, 2, 4), (4, 4, 2, 3), (4, 4, 2, 2)]
K8_BLOCKS = [2, 3, 4]          # K8 at D <= 64: blocks an SM asked of ptxas
K8_SPLITS = {"F": [0, 1, 2, 4, 8, 16], "cat500k": [0, 16, 33, 66, 132]}   # 0: dq_plan's

ORDER_LINE = "q0 = blockIdx.x * TQ"     # K4's, the first in the source


def k4_source(include: str) -> str:
    cases = "\n".join(
        f"    case {i}: return (int)sweep_fwd<{ri}, {cj}, {dk}, {mb}>(a, vec, st);"
        for i, (ri, cj, dk, mb) in enumerate(K4_PLANS))
    return f'''#include "{include}"
namespace {{
template <int RI, int CJ, int DK, int MINB>
cudaError_t sweep_fwd(const FlashArgs& a, bool vec, cudaStream_t st) {{
  constexpr int TQ = 16 * RI, TK = 16 * CJ, LD = 16 * DK + 4;
  constexpr size_t floats = (size_t)(TQ + 2 * TK) * LD + (size_t)TQ * (TK + 4);
  return launch(flash_fwd_kernel<RI, CJ, DK, MINB>, cdiv(a.Lq, TQ), floats, a.H, a.B, st, a,
                vec);
}}
}}  // namespace
extern "C" int sweep_k4(int plan, const float* q, const float* k, const float* v,
                        const float* pad_add, const float* attn_add, float* out, float* stats,
                        int B, int H, int Lq, int Lk, int Dh, float scale, void* stream) {{
  FlashArgs a = make_args(q, k, v, pad_add, attn_add, B, H, Lq, Lk, Dh, scale);
  a.o = out;
  a.st = stats;
  const bool vec = vec_rows(a);
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan) {{
{cases}
  }}
  return (int)cudaErrorInvalidValue;
}}
'''


def k8_source(include: str) -> str:
    cases = "\n".join(f"    case {b}: return f(lse_bwd_dq_kernel<4, {b}>);" for b in K8_BLOCKS)
    return f'''#include "{include}"
namespace {{
template <typename F>
int with_kernel(int blocks, F f) {{
  switch (blocks) {{
{cases}
  }}
  return -1;
}}
}}  // namespace
// Blocks of the plan the card holds at once (occupancy times SMs).
extern "C" int sweep_k8_resident(int blocks) {{
  const size_t smem = dq_floats<4>() * sizeof(float);
  return with_kernel(blocks, [&](auto kernel) {{
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    return per_sm * sms;
  }});
}}
// Ranges of the plan: `splits` forced, or dq_plan's for this residency (0).
extern "C" int sweep_k8_splits(int blocks, int splits, int M, int N, int D) {{
  const int T = cdiv(N, kT);
  if (splits > 0) return cdiv(T, cdiv(T, splits));
  return dq_plan(M, N, D, sweep_k8_resident(blocks)).splits;
}}
extern "C" int sweep_k8(int blocks, int splits, const float* q, const float* items,
                        const float* logz, const float* g, float* part, float* dq, int M, int N,
                        int D, void* stream) {{
  const int T = cdiv(N, kT), S = sweep_k8_splits(blocks, splits, M, N, D);
  const Plan plan = {{S, cdiv(T, S)}};
  const size_t smem = dq_floats<4>() * sizeof(float);
  const bool vec = D % 4 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return with_kernel(blocks, [&](auto kernel) {{
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(cdiv(M, kT), plan.splits), kThreads, smem, st>>>(
        q, items, logz, g, part, dq, M, N, D, plan.per, plan.splits, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess || plan.splits == 1) return (int)err;
    sum_parts_kernel<<<cdiv((long long)M * D, kThreads), kThreads, 0, st>>>(part, g, dq, M, D,
                                                                         plan.splits);
    return (int)cudaGetLastError();
  }});
}}
'''


def build(out_dir: str):
    """Compile the three sweep sources in parallel; returns the loaded
    libraries and the compilers' register report."""
    from recstudio_torch.ops import _native
    csrc = os.path.join(REPO, "recstudio_torch", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "flash_attention.cu")) as f:
        flash = f.read()
    at = flash.find(ORDER_LINE)
    k4, k5 = flash.find("flash_fwd_kernel(const FlashArgs a"), flash.find("flash_bwd_dq_kernel(")
    if not k4 < at < k5:
        raise RuntimeError("K4's grid order line moved")
    last_first = os.path.join(out_dir, "flash_attention_last_first.cu")
    with open(last_first, "w") as f:
        f.write(flash[:at] + "q0 = (gridDim.x - 1 - blockIdx.x) * TQ"
                + flash[at + len(ORDER_LINE):])
    sources = {"k4": k4_source(os.path.join(csrc, "flash_attention.cu")),
               "k4_last_first": k4_source(last_first),
               "k8": k8_source(os.path.join(csrc, "softmax_z.cu"))}
    nvcc, procs = _native._nvcc(), {}
    for name, text in sources.items():
        src = os.path.join(out_dir, f"sweep_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_native.ARCH_FLAGS, *_native.CFLAGS, f"-I{csrc}", "-shared", src, "-o",
             os.path.join(out_dir, f"libsweep_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, report = {}, []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} sweep:\n{out}")
        if name != "k4_last_first":
            report += [f"{name}: {ln.strip()}" for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"libsweep_{name}.so"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("k4", "k4_last_first"):
        libs[name].sweep_k4.argtypes = [I] + [P] * 7 + [I] * 5 + [F, P]
    libs["k8"].sweep_k8.argtypes = [I, I] + [P] * 6 + [I] * 3 + [P]
    libs["k8"].sweep_k8_splits.argtypes = [I] * 5
    libs["k8"].sweep_k8_resident.argtypes = [I]
    return libs, report


def call(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with cudaError_t {err}")


def sweep_k4(libs, device, rows):
    import torch
    from chip_smoke import flash_inputs, time_ms
    from recstudio_torch.ops.attention import flash_mha_fwd
    for tag, (B, H, L, Dh) in (("H", (256, 2, 1024, 64)), ("odd", (64, 2, 600, 32))):
        q, k, v, _, _, _, (pad_add, attn_add) = flash_inputs(device, B, H, L, Dh, True, True,
                                                             2029)
        want, want_stats = flash_mha_fwd(q, k, v, pad_add, attn_add)
        shipped_ms = time_ms(lambda: flash_mha_fwd(q, k, v, pad_add, attn_add))
        rows.append({"kernel": "K4", "at": tag, "plan": "shipped", "ms": shipped_ms})
        out, stats = torch.empty_like(q), torch.empty((B, H, L, 2), device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        for lib_name in ("k4", "k4_last_first"):
            for i, (ri, cj, dk, mb) in enumerate(K4_PLANS):
                if (dk == 2) != (Dh <= 32):
                    continue
                fn = getattr(libs[lib_name], "sweep_k4")
                run = lambda: call(fn, i, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   pad_add.data_ptr(), attn_add.data_ptr(), out.data_ptr(),
                                   stats.data_ptr(), B, H, L, L, Dh, 1.0 / Dh ** 0.5, stream)
                run()
                torch.cuda.synchronize()
                ok = bool(torch.allclose(out, want, rtol=1e-4, atol=2e-5)
                          and torch.allclose(stats, want_stats, rtol=1e-4, atol=1e-4))
                rows.append({"kernel": "K4", "at": tag, "tile": [16 * ri, 16 * cj],
                             "blocks_per_sm": mb, "dk": dk,
                             "order": "in order" if lib_name == "k4" else "last tile first",
                             "ok": ok, "ms": time_ms(run)})


def sweep_k8(libs, device, rows):
    import torch
    from chip_smoke import clse_inputs, time_ms
    from recstudio_torch.ops.softmax_z import (DQ_PLAN, catalog_logsumexp_dq,
                                               catalog_logsumexp_fwd, splits)
    lib = libs["k8"]
    stream = torch.cuda.current_stream(device).cuda_stream
    for tag, (M, N, D) in (("F", (256 * 200, 3706, 64)), ("cat500k", (512, 500_000, 64))):
        q, items, g = clse_inputs(device, M, N, D, 2028)
        logz = catalog_logsumexp_fwd(q, items)
        want = catalog_logsumexp_dq(q, items, logz, g)
        rows.append({"kernel": "K8", "at": tag, "plan": "shipped",
                     "splits": splits(M, N, D, DQ_PLAN),
                     "ms": time_ms(lambda: catalog_logsumexp_dq(q, items, logz, g))})
        dq = torch.empty_like(q)
        for blocks in K8_BLOCKS:
            for forced in K8_SPLITS[tag]:
                S = lib.sweep_k8_splits(blocks, forced, M, N, D)
                part = torch.empty((S * M * D if S > 1 else 1,), device=device)
                run = lambda: call(lib.sweep_k8, blocks, forced, q.data_ptr(),
                                   items.data_ptr(), logz.data_ptr(), g.data_ptr(),
                                   part.data_ptr(), dq.data_ptr(), M, N, D, stream)
                run()
                torch.cuda.synchronize()
                scale = float(want.abs().max())
                ok = bool(torch.allclose(dq, want, rtol=1e-3, atol=1e-4 * scale))
                rows.append({"kernel": "K8", "at": tag, "blocks_per_sm": blocks,
                             "resident": lib.sweep_k8_resident(blocks),
                             "splits": S, "plan": "dq_plan" if forced == 0 else "forced",
                             "grid_blocks": -(-M // 64) * S, "ok": ok, "ms": time_ms(run)})


def main() -> int:
    import torch
    from chip_smoke import gpu_line
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    gpu = gpu_line()
    t0 = time.perf_counter()
    libs, report = build(os.path.join(REPO, "build", "recstudio_torch", "sweep"))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for ln in report:
        print(f"PTXAS {ln}", flush=True)
    rows = []
    sweep_k4(libs, device, rows)
    sweep_k8(libs, device, rows)
    for row in rows:
        print(f"PLAN {json.dumps({'gpu': gpu, **row})}", flush=True)
    print(f"GPU {gpu_line()}", flush=True)
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
