#!/usr/bin/env python3
"""Time other tile and occupancy plans of the flash forward (K4), the
catalog log-partition kernels (K7, K8, K9) and the fused layer's forward
(K1) and backward (K2), and K1's and K2's time by step, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and ``nvcc``::

    python3 scripts/torch_kernel_sweep.py [k4] [k7] [k8] [k9] [k2steps] [k2gemm] [k2attn]
        [k1steps] [k1gemm]

(all parts when none is named). ``k4``, ``k7``, ``k8``, ``k9``, ``k2gemm``,
``k2attn`` and ``k1gemm`` compile ``recstudio_torch/csrc/flash_attention.cu``,
``softmax_z.cu``, ``transformer_layer_bwd.cu`` and ``transformer_layer.cu``
once more (only those the named parts need), each with launchers of other
plans of the same kernels (``build/recstudio_torch/sweep/``), and a copy of
the first whose K4 grid runs the last query tiles first (under the causal
mask they stream the most key tiles). Each plan is timed with CUDA events
at the shapes ``chip_smoke.py`` uses and held to the shipped kernel's
output or to ``torch.matmul``:

- K4: phase H's B 256, H 2, L 1024, Dh 64, causal, right padding, example
  0 fully padded, and the Dh 32 ``odd`` row;
- K7, K8, K9 (blocks an SM asked of ptxas, and ranges: the plan's rule
  for that residency, or forced): phase F's M 51,200, N 3,706, D 64, and M
  512, N 500,000; K7 and K9 also phase G's M 10,240, N 1,574;
- K2 (``k2gemm``): each of its eight products at phase D's (B 1024, L 200,
  d 128, F 128) and F's (B 256, L 200, d 64) shapes on every tile of
  ``K2_GEMM_PLANS`` (rows and columns a block, k-slice, cp.async stages),
  the weight gradients with their row ranges sized to the card for each;
- K2 (``k2attn``): its attention steps (K5's and K6's kernels, dropout on)
  at those phases' inputs on every plan of ``K2_ATTN_PLANS`` (query rows
  and keys of a pair of tiles, blocks an SM);
- K1 (``k1gemm``): each of its four products with its epilogue (bias,
  activation, dropout, residual and LayerNorm) at phase D's shape in
  training mode and B's (B 256, L 200, d 128) and F's in eval, on every
  tile of ``K1_GEMM_PLANS`` that covers the step, held to the plan the
  port ships for it (``forward_tiles``);
- ``k2steps`` and ``k1steps``: K2 at D's and F's inputs, K1 at D's
  (training) and B's and F's (eval), as the port builds them: the card's
  time by step from ``torch.profiler`` (each launch given its step by its
  place in the chain; median over 10 calls), beside float32
  ``torch.matmul`` (TF32 off) of each product step: a yardstick, not used
  by the port. These parts need only the kernels' entry points, so they
  run on earlier trees too.

Prints the compilers' register report, one ``PLAN`` JSON line per plan or
step, and the card's name and power limit.
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
CLSE_BLOCKS = [2, 3, 4]        # K7, K8, K9 at D <= 64: blocks an SM asked of ptxas
# phase F's (BERT4Rec at batch 256, L 200 on the ml-1m shape), a 500,000-item
# catalog, and phase G's (batch 512, L 20 on ml-100k): (M, N, D)
CLSE_SHAPES = {"F": (256 * 200, 3706, 64), "cat500k": (512, 500_000, 64),
               "G": (512 * 20, 1574, 64)}
# ranges forced at each shape (0: the rule's for the residency)
CLSE_SPLITS = {"k7": {"F": [0, 1, 2, 4, 6, 10, 20, 58], "cat500k": [0, 33, 49, 66, 99, 132, 264],
                      "G": [0, 1, 2, 3, 7, 13, 25]},
               "k8": {"F": [0, 1, 2, 4, 8, 16], "cat500k": [0, 16, 33, 66, 132]},
               "k9": {"F": [0, 1, 4, 9, 20, 40, 100], "cat500k": [0, 1, 2, 4, 8],
                      "G": [0, 1, 5, 10, 15, 20, 40]}}

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


# the catalog kernels' sweeps: (kernel, shared memory, plan, launcher), and
# the axis their plan cuts
CLSE_KERNELS = {"k7": ("lse_fwd_kernel", "fwd_floats", "fwd_plan", "launch_fwd", "N"),
                "k8": ("lse_bwd_dq_kernel", "bwd_floats", "dq_plan", "launch_dq", "N"),
                "k9": ("lse_bwd_ditems_kernel", "bwd_floats", "ditems_plan", "launch_ditems",
                       "M")}


def clse_source(include: str, part: str) -> str:
    """K7, K8 or K9 at D <= 64 with ``CLSE_BLOCKS`` blocks an SM asked of
    ptxas, launched on the plan of its rule for that residency or on a
    forced number of ranges."""
    kernel, floats, plan, launch, axis = CLSE_KERNELS[part]
    cases = "\n".join(f"    case {b}: return f(&{kernel}<4, {b}>);" for b in CLSE_BLOCKS)
    grads = "" if part == "k7" else "logz, g, "
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
extern "C" int sweep_{part}_resident(int blocks) {{
  return with_kernel(blocks, [](auto kernel) {{ return occupancy(kernel, {floats}<4>()); }});
}}
// Ranges of the plan: `splits` forced, or the rule's for this residency (0).
extern "C" int sweep_{part}_splits(int blocks, int splits, int M, int N, int D) {{
  const int T = cdiv({axis}, kT);
  if (splits > 0) return cdiv(T, cdiv(T, splits));
  return {plan}(M, N, D, sweep_{part}_resident(blocks)).splits;
}}
extern "C" int sweep_{part}(int blocks, int splits, const float* q, const float* items,
                          const float* logz, const float* g, float* part, float* out, int M,
                          int N, int D, void* stream) {{
  const int T = cdiv({axis}, kT), S = sweep_{part}_splits(blocks, splits, M, N, D);
  const Plan plan = {{S, cdiv(T, S)}};
  const bool vec = D % 4 == 0;
  return with_kernel(blocks, [&](auto kernel) {{
    return (int){launch}(kernel, {floats}<4>(), q, items, {grads}part, out, M, N, D, vec, plan,
                         (cudaStream_t)stream);
  }});
}}
'''


# K2's product tiles: (output rows / 16, output columns / 16, k-slice, stages)
K2_GEMM_PLANS = [(8, 8, 16, 2), (8, 8, 8, 3), (8, 8, 8, 2), (8, 8, 8, 4), (8, 4, 16, 2),
                 (8, 4, 8, 3), (4, 8, 16, 2), (4, 8, 8, 3), (4, 4, 16, 2), (4, 4, 8, 3)]
# K2's attention steps: (query rows / 16, keys / 16, accumulator columns / 16,
# most blocks an SM); Dh 64 (phase D) takes DK 4, Dh 32 (phase F) DK 2
K2_ATTN_PLANS = [(2, 2, 4, 4), (4, 4, 4, 4), (4, 2, 4, 4), (2, 4, 4, 4), (2, 2, 4, 3),
                 (2, 2, 4, 2), (2, 2, 2, 4), (2, 2, 2, 3), (2, 2, 2, 2), (4, 4, 2, 4),
                 (4, 4, 2, 3), (4, 2, 2, 4), (2, 4, 2, 4)]


def k2_gemm_source(include: str) -> str:
    tiles = [f"GemmTile<{tm}, {tn}, {bk}, {st}>" for tm, tn, bk, st in K2_GEMM_PLANS]
    nn = "\n".join(f"    case {i}: return nn<{t}>(A, B, C, aux, M, N, K, st);"
                    for i, t in enumerate(tiles))
    tn = "\n".join(f"    case {i}: return tn<{t}>(A, B, dw, db, pw, pb, M, N, K, st, S);"
                    for i, t in enumerate(tiles))
    return f'''#include "{include}"
namespace {{
template <class T>
int nn(const float* A, const float* B, float* C, const float* aux, int M, int N, int K,
       cudaStream_t st) {{
  const dim3 grid(cdiv(M, T::BM), cdiv(N, T::BN));
  gemm_nn_kernel<T, kEpiRes><<<grid, kThreads, 0, st>>>(
      A, B, C, M, N, K, aux, DropParams{{0, 0, 1.f, 0}}, 0, kGelu, N % 4 == 0 && aligned16(B),
      N % 4 == 0 && aligned16(C));
  return (int)cudaGetLastError();
}}
template <class T>
int tn(const float* A, const float* B, float* dw, float* db, float* pw, float* pb, int M, int N,
       int K, cudaStream_t st, int* S) {{
  const RowPlan plan = row_plan<T>(M, N, K, tn_resident<T>());
  *S = plan.S;
  if (!pw) return 0;
  gemm_tn_partial_kernel<T><<<dim3(cdiv(K, T::BN), cdiv(N, T::BM), plan.S), kThreads, 0, st>>>(
      A, B, pw, pb, M, N, K, plan.rows, N % 4 == 0 && aligned16(A), K % 4 == 0 && aligned16(B),
      K % 4 == 0 && aligned16(pw));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(pw, dw, (long long)N * K, pb, db, N, plan.S, st);
}}
}}  // namespace
extern "C" int sweep_k2_nn(int plan, const float* A, const float* B, float* C, const float* aux,
                           int M, int N, int K, void* stream) {{
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan) {{
{nn}
  }}
  return (int)cudaErrorInvalidValue;
}}
// With pw null: only the plan's ranges, in *S.
extern "C" int sweep_k2_tn(int plan, const float* A, const float* B, float* dw, float* db,
                           float* pw, float* pb, int M, int N, int K, void* stream, int* S) {{
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan) {{
{tn}
  }}
  return (int)cudaErrorInvalidValue;
}}
'''


def k2_attn_source(include: str) -> str:
    cases = "\n".join(
        f"    case {i}: return (int)launch_bwd<{ri}, {cj}, {dk}, true, {cap}>(a, vec, st);"
        for i, (ri, cj, dk, cap) in enumerate(K2_ATTN_PLANS))
    return f'''#include "{include}"
// K2's steps 9 and 10 on its packed rows (as rs_transformer_layer_bwd), dropout on.
extern "C" int sweep_k2_attn(int plan, const float* qkv, const float* pad_add,
                             const float* attn_add, const float* stats, const float* attn,
                             const float* dA, float* dqkv, float* delta, int B, int L, int D,
                             int H, float scale, unsigned long long seed, unsigned int threshold,
                             float drop_scale, void* stream) {{
  MhaParams p = {{}};
  const int Dh = D / H;
  p.q = qkv;
  p.k = qkv + D;
  p.v = qkv + 2 * D;
  p.pad_add = pad_add;
  p.attn_add = attn_add;
  p.B = B;
  p.H = H;
  p.Lq = p.Lk = L;
  p.Dh = Dh;
  p.q_sb = p.k_sb = p.v_sb = (long long)L * 3 * D;
  p.q_sh = p.k_sh = p.v_sh = Dh;
  p.q_sl = p.k_sl = p.v_sl = 3 * D;
  p.o_sb = (long long)L * D;
  p.o_sh = Dh;
  p.o_sl = D;
  p.scale = scale;
  p.stats = const_cast<float*>(stats);
  p.drop = {{seed, threshold, drop_scale, 1}};
  const FlashArgs a = layer_args(p, attn, dA, dqkv, dqkv + D, dqkv + 2 * D, delta);
  const bool vec = vec_rows(a);
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan) {{
{cases}
  }}
  return (int)cudaErrorInvalidValue;
}}
'''


def build(out_dir: str, parts):
    """Compile the sweep sources of ``parts`` in parallel; returns the
    loaded libraries and the compilers' register report."""
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
               **{p: clse_source(os.path.join(csrc, "softmax_z.cu"), p) for p in CLSE_KERNELS},
               "k2gemm": k2_gemm_source(os.path.join(csrc, "transformer_layer_bwd.cu")),
               "k2attn": k2_attn_source(os.path.join(csrc, "flash_attention.cu")),
               "k1gemm": k1_gemm_source(os.path.join(csrc, "transformer_layer.cu"))}
    sources = {name: text for name, text in sources.items() if name.split("_")[0] in parts}
    # the products' sources call K2's and K1's attention launchers: link their definitions
    extra = {"k2gemm": [os.path.join(csrc, "flash_attention.cu")],
             "k1gemm": [os.path.join(csrc, "attention.cu")]}
    nvcc, procs = _native._nvcc(), {}
    for name, text in sources.items():
        src = os.path.join(out_dir, f"sweep_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_native.ARCH_FLAGS, *_native.CFLAGS, f"-I{csrc}", "-shared", src,
             *extra.get(name, []), "-o", os.path.join(out_dir, f"libsweep_{name}.so")],
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
    U64, U32 = ctypes.c_ulonglong, ctypes.c_uint
    argtypes = {
        "k4": {"sweep_k4": [I] + [P] * 7 + [I] * 5 + [F, P]},
        "k4_last_first": {"sweep_k4": [I] + [P] * 7 + [I] * 5 + [F, P]},
        **{p: {f"sweep_{p}": [I, I] + [P] * 6 + [I] * 3 + [P], f"sweep_{p}_splits": [I] * 5,
               f"sweep_{p}_resident": [I]} for p in CLSE_KERNELS},
        "k2gemm": {"sweep_k2_nn": [I] + [P] * 4 + [I] * 3 + [P],
                   "sweep_k2_tn": [I] + [P] * 6 + [I] * 3 + [P, P]},
        "k2attn": {"sweep_k2_attn": [I] + [P] * 8 + [I] * 4 + [F, U64, U32, F, P]},
        "k1gemm": {"sweep_k1_bias_act": [I, I] + [P] * 5 + [I] * 4 + [U64, U32, F, P],
                   "sweep_k1_residual_ln": [I, I] + [P] * 9 + [I] * 3 + [F, U64, U32, F, I, P]},
    }
    for name, lib in libs.items():
        for fn, types in argtypes[name].items():
            getattr(lib, fn).argtypes = types
    return libs, report


def call(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed with cudaError_t {err}")


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


def sweep_clse(libs, device, rows, part):
    """K7, K8 or K9 on every residency and forced plan at its shapes, held
    to the shipped kernel's output (K7: rtol 1e-5, atol 1e-4; K8, K9: rtol
    1e-3, atol 1e-4 times the largest magnitude: sums in another order)."""
    import torch
    from chip_smoke import clse_inputs, time_ms
    from recstudio_torch.ops.softmax_z import (DITEMS_PLAN, DQ_PLAN, FWD_PLAN,
                                               catalog_logsumexp_ditems, catalog_logsumexp_dq,
                                               catalog_logsumexp_fwd, splits)
    lib = libs[part]
    kernel = part.upper()
    kind, shipped = {"k7": (FWD_PLAN, lambda q, items, logz, g: catalog_logsumexp_fwd(q, items)),
                     "k8": (DQ_PLAN, catalog_logsumexp_dq),
                     "k9": (DITEMS_PLAN, catalog_logsumexp_ditems)}[part]
    stream = torch.cuda.current_stream(device).cuda_stream
    for tag, forced_splits in CLSE_SPLITS[part].items():
        M, N, D = CLSE_SHAPES[tag]
        q, items, g = clse_inputs(device, M, N, D, 2028)
        logz = catalog_logsumexp_fwd(q, items)
        want = shipped(q, items, logz, g)
        rows.append({"kernel": kernel, "at": tag, "plan": "shipped",
                     "splits": splits(M, N, D, kind),
                     "ms": time_ms(lambda: shipped(q, items, logz, g))})
        out = torch.empty_like(want)
        per_split = {"k7": 2 * M, "k8": M * D, "k9": N * D}[part]
        for blocks in CLSE_BLOCKS:
            for forced in forced_splits:
                S = getattr(lib, f"sweep_{part}_splits")(blocks, forced, M, N, D)
                ws = torch.empty((S * per_split if S > 1 else 1,), device=device)
                fn = getattr(lib, f"sweep_{part}")
                run = lambda: call(fn, blocks, forced, q.data_ptr(), items.data_ptr(),
                                   logz.data_ptr(), g.data_ptr(), ws.data_ptr(),
                                   out.data_ptr(), M, N, D, stream)
                run()
                torch.cuda.synchronize()
                if part == "k7":
                    ok = bool(torch.allclose(out, want, rtol=1e-5, atol=1e-4))
                else:
                    scale = float(want.abs().max())
                    ok = bool(torch.allclose(out, want, rtol=1e-3, atol=1e-4 * scale))
                outer = N if part == "k9" else M
                rows.append({"kernel": kernel, "at": tag, "blocks_per_sm": blocks,
                             "resident": getattr(lib, f"sweep_{part}_resident")(blocks),
                             "splits": S, "plan": "rule" if forced == 0 else "forced",
                             "grid_blocks": -(-outer // 64) * S, "ok": ok, "ms": time_ms(run)})
                del ws


# K2's launches in the order of its chain, by step (transformer_layer_bwd.cu)
K2_STEPS = [1, 1, 2, 2, 3, 4, 4, 5, 6, 6, 7, 7, 8, 9, 10, 11, 11, 12]
K2_STEP_NAMES = {1: "LN2 backward", 2: "dW2, db2", 3: "dhpre", 4: "dW1, db1", 5: "dx1",
                 6: "LN1 backward", 7: "dWo, dbo", 8: "dA", 9: "attention dq",
                 10: "attention dk, dv", 11: "dWqkv, dbqkv", 12: "dx"}
# phase D's and F's K2 rows of chip_smoke.py: (B, L, D, F, H, dropout, causal)
K2_SHAPES = {"D": (1024, 200, 128, 128, 2, 0.5, True), "F": (256, 200, 64, 128, 2, 0.2, False)}


def k2_products(M, D, F):
    """The eight products of K2's chain as (step, (rows, depth, columns),
    transposed first operand): torch.matmul's yardstick for each."""
    return [(2, (D, M, F), True), (3, (M, D, F), False), (4, (F, M, D), True),
            (5, (M, F, D), False), (7, (D, M, D), True), (8, (M, D, D), False),
            (11, (3 * D, M, D), True), (12, (M, 3 * D, D), False)]


def profile_steps(run, n, calls=10):
    """The card's kernel times of ``calls`` calls of ``run``, which launches
    ``n`` kernels of its own (PyTorch's, such as the additive masks the
    wrappers make, are left out): the median over the calls of each
    launch, and the launches' names, or None if the profiler missed some."""
    import torch
    from torch.autograd import DeviceType
    for _ in range(3):          # the profiler has been seen to drop launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                       and "at::native" not in e.name and "mem" not in e.name.lower()),
                      key=lambda e: e.time_range.start)
        if len(kern) == n * calls:
            per_launch = [sorted(kern[c * n + i].time_range.elapsed_us() / 1e3
                                 for c in range(calls))[calls // 2] for i in range(n)]
            return per_launch, [kern[i].name for i in range(n)]
    return None, len(kern)


def k2_steps(device, rows, calls=10):
    """K2's time by step at phase D's and F's inputs: the card's kernel
    times from torch.profiler over ``calls`` calls, each launch given its
    step by its place in the chain (median over the calls), and beside each
    product step float32 torch.matmul (TF32 off) of the same product."""
    import torch
    from chip_smoke import layer_inputs, time_ms
    from recstudio_torch.ops.transformer_layer import (fused_transformer_layer_bwd,
                                                       training_residuals)
    for tag, (B, L, D, F, H, p, causal) in K2_SHAPES.items():
        params, x, g, pad, attn = layer_inputs(device, B, L, D, F, B + L + 3, causal)
        _, res = training_residuals(x, params, pad, attn, H, p, "gelu", 1e-12, 2027)
        run = lambda: fused_transformer_layer_bwd(g, x, params, pad, attn, H, p, "gelu",
                                                  1e-12, 2027, res)
        call_ms = time_ms(run)
        n = len(K2_STEPS)
        per_launch, names = profile_steps(run, n, calls)
        if per_launch is None:
            rows.append({"kernel": "K2", "at": tag, "ok": False, "steps": "profiler saw "
                         f"{names} K2 launches, expected {n * calls}"})
            continue
        M = B * L
        yard = {}
        for step, (rows_, depth, cols), trans in k2_products(M, D, F):
            a = torch.randn((depth, rows_) if trans else (rows_, depth), device=device)
            b = torch.randn((depth, cols), device=device)
            yard[step] = time_ms(lambda: torch.matmul(a.t() if trans else a, b))
        total = sum(per_launch)
        for step, label in K2_STEP_NAMES.items():
            ms = sum(t for s, t in zip(K2_STEPS, per_launch) if s == step)
            rows.append({"kernel": "K2", "at": tag, "step": step, "name": label, "ms": ms,
                         "share": ms / total, "matmul_ms": yard.get(step),
                         "launches": [nm[:60] for s, nm in zip(K2_STEPS, names) if s == step]})
        rows.append({"kernel": "K2", "at": tag, "steps_total_ms": total, "call_ms": call_ms})


def k2_shipped_gemm(rows, cols):
    """The product tile K2 ships for an output of ``rows`` x ``cols``
    (transformer_layer_bwd.cu tile_side): 64 on a side 64 wide or less."""
    side = lambda n: 4 if n <= 64 else 8
    return (side(rows), side(cols), 16, 2)


def sweep_k2_gemm(libs, device, rows):
    """Each of K2's product steps at phase D's and F's shapes on every tile
    plan of ``K2_GEMM_PLANS``, held to float32 torch.matmul (TF32 off):
    C = A B + aux (the data gradients' residual epilogue) and dW = A^T B
    with the weight-gradient kernel's row ranges, sized to the card for
    each plan, and their in-order sum."""
    import ctypes
    import torch
    from chip_smoke import time_ms
    lib = libs["k2gemm"]
    stream = torch.cuda.current_stream(device).cuda_stream
    for tag, (B, L, D, F, H, p, causal) in K2_SHAPES.items():
        M = B * L
        for step, (r, depth, c), trans in k2_products(M, D, F):
            S = ctypes.c_int(0)
            if trans:       # dW [r, c] = A^T B, A [M, r], B [M, c]
                a, b = torch.randn((M, r), device=device), torch.randn((M, c), device=device)
                want = torch.matmul(a.t(), b)
                out, db = torch.empty((r, c), device=device), torch.empty(r, device=device)
                need = []
                for i in range(len(K2_GEMM_PLANS)):
                    call(lib.sweep_k2_tn, i, a.data_ptr(), b.data_ptr(), None, None, None, None,
                         M, r, c, stream, ctypes.addressof(S))
                    need.append(S.value)
                pw = torch.empty(max(need) * r * c, device=device)
                pb = torch.empty(max(need) * r, device=device)
            else:           # C [M, c] = A [M, depth] B [depth, c] + aux
                a, b = (torch.randn((M, depth), device=device),
                        torch.randn((depth, c), device=device))
                aux = torch.randn((M, c), device=device)
                want = torch.addmm(aux, a, b)
                out = torch.empty((M, c), device=device)
            for i, plan in enumerate(K2_GEMM_PLANS):
                if trans:
                    run = lambda: call(lib.sweep_k2_tn, i, a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), db.data_ptr(), pw.data_ptr(),
                                       pb.data_ptr(), M, r, c, stream, ctypes.addressof(S))
                else:
                    run = lambda: call(lib.sweep_k2_nn, i, a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), aux.data_ptr(), M, c, depth, stream)
                out.zero_()
                run()
                torch.cuda.synchronize()
                scale = float(want.abs().max())
                ok = bool(torch.allclose(out, want, rtol=1e-3, atol=1e-4 * scale))
                if trans:
                    ok &= bool(torch.allclose(db, a.sum(0), rtol=1e-3,
                                              atol=1e-4 * float(a.sum(0).abs().max())))
                tm, tn, bk, st = plan
                rows.append({"kernel": "K2", "at": tag, "step": step, "name": K2_STEP_NAMES[step],
                             "tile": [16 * tm, 16 * tn], "k_slice": bk, "stages": st,
                             "shipped": plan == (k2_shipped_gemm(r, c) if trans
                                                 else (8, *k2_shipped_gemm(r, c)[1:])),
                             "splits": S.value if trans else None, "ok": ok, "ms": time_ms(run)})
            del a, b, out, want


def sweep_k2_attn(libs, device, rows):
    """K2's attention steps (K5's then K6's kernel, dropout on) at phase D's
    and F's inputs on every plan of ``K2_ATTN_PLANS`` for their head width,
    held to the first (the shipped 32 x 32, at most four blocks an SM); with the share of
    tile pairs each plan computes (``mha_tiles``)."""
    import torch
    from chip_smoke import layer_inputs, time_ms
    from recstudio_torch.ops.attention import additive_masks, mha_tiles
    from recstudio_torch.ops.dropout import drop_args
    from recstudio_torch.ops.transformer_layer import training_residuals
    lib = libs["k2attn"]
    stream = torch.cuda.current_stream(device).cuda_stream
    for tag, (B, L, D, F, H, p, causal) in K2_SHAPES.items():
        params, x, _, pad, attn = layer_inputs(device, B, L, D, F, B + L + 3, causal)
        _, res = training_residuals(x, params, pad, attn, H, p, "gelu", 1e-12, 2027)
        pad_add, attn_add = additive_masks(pad, attn)
        M, Dh = B * L, D // H
        dA = torch.randn((M, D), device=device)
        dqkv = torch.zeros((M, 3 * D), device=device)
        delta = torch.empty((B, H, L), device=device)
        seed, thr, drop_scale = drop_args(p, 2027)
        ref = None
        for i, (ri, cj, dk, cap) in enumerate(K2_ATTN_PLANS):
            if dk != (2 if Dh <= 32 else 4):
                continue
            run = lambda: call(lib.sweep_k2_attn, i, res["qkv"].data_ptr(), pad_add.data_ptr(),
                               None if attn_add is None else attn_add.data_ptr(),
                               res["stats"].data_ptr(), res["attn"].data_ptr(), dA.data_ptr(),
                               dqkv.data_ptr(), delta.data_ptr(), B, L, D, H, Dh ** -0.5,
                               seed, thr, drop_scale, stream)
            run()
            torch.cuda.synchronize()
            got = dqkv.clone()
            if ref is None:
                ref = got
            ok = bool(torch.allclose(got, ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max())))
            tiles, empty = mha_tiles(pad, attn, L, L, 16 * ri, 16 * cj)
            rows.append({"kernel": "K2 attention", "at": tag, "tile": [16 * ri, 16 * cj],
                         "dk": dk, "max_blocks_per_sm": cap,
                         "tiles_computed_share": float((tiles | empty[:, :, None]).float().mean()),
                         "ok": ok, "ms": time_ms(run)})


# K1's launches in the order of its chain (transformer_layer.cu)
K1_STEP_NAMES = {1: "qkv = x Wqkv^T + b", 2: "attention (K3)", 3: "x1 = LN1(A Wo^T + bo + x)",
                 4: "h = act(x1 W1^T + b1)", 5: "out = LN2(h W2^T + b2 + x1)"}
# phase D's training row and B's and F's eval rows of chip_smoke.py:
# (B, L, D, F, H, dropout (None: eval), causal)
K1_SHAPES = {"D": (1024, 200, 128, 128, 2, 0.5, True), "B": (256, 200, 128, 128, 2, None, True),
             "F": (256, 200, 64, 128, 2, None, False)}


def k1_products(M, D, F):
    """K1's four product steps as (step, (rows, depth, columns), LayerNorm
    epilogue): qkv, Wo, W1, W2."""
    return [(1, (M, D, 3 * D), False), (3, (M, D, D), True), (4, (M, D, F), False),
            (5, (M, F, D), True)]


def k1_steps(device, rows):
    """K1's time by launch at phase D's training inputs and B's and F's eval
    inputs (``torch.profiler``, median over 10 calls), beside float32
    torch.matmul (TF32 off) of each product step. Needs only K1's entry
    points, so it runs on earlier trees too."""
    import torch
    from chip_smoke import layer_inputs, time_ms
    from recstudio_torch.ops.transformer_layer import (fused_transformer_layer,
                                                       training_residuals)
    for tag, (B, L, D, F, H, p, causal) in K1_SHAPES.items():
        params, x, _, pad, attn = layer_inputs(device, B, L, D, F, B + L + 2, causal)
        if p is None:
            run = lambda: fused_transformer_layer(x, params, pad, attn, H, 0.0, "gelu", 1e-12,
                                                  False)
        else:
            run = lambda: training_residuals(x, params, pad, attn, H, p, "gelu", 1e-12, 2026)
        with torch.no_grad():
            call_ms = time_ms(run)
            per_launch, names = profile_steps(run, len(K1_STEP_NAMES))
        if per_launch is None:
            rows.append({"kernel": "K1", "at": tag, "ok": False, "steps": "profiler saw "
                         f"{names} launches, expected {len(K1_STEP_NAMES) * 10}"})
            continue
        M = B * L
        yard = {}
        for step, (r, depth, c), _ in k1_products(M, D, F):
            a = torch.randn((r, depth), device=device)
            w = torch.randn((c, depth), device=device)
            yard[step] = time_ms(lambda: torch.matmul(a, w.t()))
        total = sum(per_launch)
        for (step, label), ms, name in zip(K1_STEP_NAMES.items(), per_launch, names):
            rows.append({"kernel": "K1", "at": tag, "mode": "eval" if p is None else "training",
                         "step": step, "name": label, "ms": ms, "share": ms / total,
                         "matmul_ms": yard.get(step), "launch": name[:60]})
        rows.append({"kernel": "K1", "at": tag, "steps_total_ms": total, "call_ms": call_ms})


# K1's product tiles: (output rows / 16, output columns / 16, k-slice, stages)
# (128 x 128 with k-slices of 16 in three buffers needs 50,688 bytes of
# static shared memory, over the 48 KB a block may declare)
K1_GEMM_PLANS = [(8, 8, 16, 2), (8, 8, 8, 3), (8, 8, 8, 2), (8, 8, 8, 4), (8, 4, 16, 2),
                 (8, 4, 8, 3), (4, 8, 16, 2), (4, 8, 8, 3), (4, 4, 16, 2), (4, 16, 16, 2)]


def k1_gemm_source(include: str) -> str:
    tiles = [f"GemmTile<{tm}, {tn}, {bk}, {st}>" for tm, tn, bk, st in K1_GEMM_PLANS]
    ba = "\n".join(f"    case {i}: return train ? ba<{t}, true>(A, W, bias, C, Cpre, M, N, K, act, "
                    f"drop, st) : ba<{t}, false>(A, W, bias, C, Cpre, M, N, K, act, drop, st);"
                    for i, t in enumerate(tiles) if not t.startswith("GemmTile<4, 16"))
    ln = "\n".join(f"    case {i}: return train ? ln<{t}, true>(A, W, bias, res, gamma, beta, out, "
                    f"xhat, rstd, M, D, K, eps, drop, site, st) : ln<{t}, false>(A, W, bias, res, "
                    f"gamma, beta, out, xhat, rstd, M, D, K, eps, drop, site, st);"
                    for i, t in enumerate(tiles))
    return f'''#include "{include}"
namespace {{
template <class T, bool TRAIN>
int ba(const float* A, const float* W, const float* bias, float* C, float* Cpre, int M, int N,
       int K, int act, DropParams drop, cudaStream_t st) {{
  const bool vec = N % 4 == 0 && aligned16(bias) && aligned16(C) && aligned16(Cpre);
  bias_act_kernel<T, TRAIN><<<dim3(cdiv(M, T::BM), cdiv(N, T::BN)), kThreads, 0, st>>>(
      A, W, bias, C, M, N, K, act, Cpre, drop, kSiteFfnHidden, vec);
  return (int)cudaGetLastError();
}}
template <class T, bool TRAIN>
int ln(const float* A, const float* W, const float* bias, const float* res, const float* gamma,
       const float* beta, float* out, float* xhat, float* rstd, int M, int D, int K, float eps,
       DropParams drop, int site, cudaStream_t st) {{
  if (D > T::BN) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && aligned16(bias) && aligned16(res) && aligned16(gamma) &&
                   aligned16(beta) && aligned16(out) && aligned16(xhat);
  residual_ln_kernel<T, TRAIN><<<cdiv(M, T::BM), kThreads, 0, st>>>(
      A, W, bias, res, gamma, beta, out, M, D, K, eps, xhat, rstd, drop, site, vec);
  return (int)cudaGetLastError();
}}
}}  // namespace
// Steps 1 and 4 (train: the pre-activation and dropout of the FFN hidden site).
extern "C" int sweep_k1_bias_act(int plan, int train, const float* A, const float* W,
                                 const float* bias, float* C, float* Cpre, int M, int N, int K,
                                 int act, unsigned long long seed, unsigned int threshold,
                                 float scale, void* stream) {{
  const DropParams drop = {{seed, threshold, scale, train}};
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan) {{
{ba}
  }}
  return (int)cudaErrorInvalidValue;
}}
// Steps 3 and 5 (train: dropout of `site`, xhat and rstd).
extern "C" int sweep_k1_residual_ln(int plan, int train, const float* A, const float* W,
                                    const float* bias, const float* res, const float* gamma,
                                    const float* beta, float* out, float* xhat, float* rstd,
                                    int M, int D, int K, float eps, unsigned long long seed,
                                    unsigned int threshold, float scale, int site,
                                    void* stream) {{
  const DropParams drop = {{seed, threshold, scale, train}};
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan) {{
{ln}
  }}
  return (int)cudaErrorInvalidValue;
}}
'''


def sweep_k1_gemm(libs, device, rows):
    """K1's four product steps, epilogues included, at phase D's (training,
    dropout 0.5), B's and F's (eval) shapes on every tile plan of
    ``K1_GEMM_PLANS`` that covers the step (a LayerNorm tile spans D), each
    held to the plan the port ships for it (``forward_tiles``)."""
    import ctypes
    import torch
    from chip_smoke import time_ms
    from recstudio_torch.ops.dropout import SITE_OUT, drop_args
    from recstudio_torch.ops.transformer_layer import forward_tiles
    lib = libs["k1gemm"]
    stream = torch.cuda.current_stream(device).cuda_stream
    for tag, (B, L, D, F, H, p, causal) in K1_SHAPES.items():
        M, train = B * L, int(p is not None)
        seed, thr, scale = drop_args(p or 0.0, 2026)
        shipped = forward_tiles(B, L, D, F, bool(train), device)
        for (step, (r, depth, c), is_ln), ship in zip(k1_products(M, D, F), shipped.values()):
            a = torch.randn((r, depth), device=device)
            w = torch.randn((c, depth), device=device) * depth ** -0.5
            bias = torch.randn(c, device=device)
            out = torch.empty((r, c), device=device)
            if is_ln:
                res = torch.randn((r, c), device=device)
                gamma, beta = torch.randn(c, device=device), torch.randn(c, device=device)
                xhat = torch.empty((r, c), device=device)
                rstd = torch.empty(r, device=device)
                fn = lambda i: lib.sweep_k1_residual_ln(
                    i, train, a.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(),
                    gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), xhat.data_ptr(),
                    rstd.data_ptr(), r, c, depth, 1e-12, seed, thr, scale, SITE_OUT, stream)
            else:
                pre = torch.empty((r, c), device=device)
                act = 2 if step == 4 else 0
                fn = lambda i: lib.sweep_k1_bias_act(
                    i, int(bool(train and act)), a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), pre.data_ptr(), r, c, depth, act, seed, thr, scale, stream)
            plans = [(i, plan) for i, plan in enumerate(K1_GEMM_PLANS)
                     if (16 * plan[1] >= c if is_ln else plan[1] <= 8)]
            ref = None
            ship_i = next(i for i, plan in plans
                          if (16 * plan[0], 16 * plan[1]) == tuple(ship) and plan[2:] == (16, 2))
            for i, plan in [(ship_i, K1_GEMM_PLANS[ship_i])] + [x for x in plans if x[0] != ship_i]:
                run = lambda: call(fn, i)
                run()
                torch.cuda.synchronize()
                got = out.clone()
                if ref is None:
                    ref = got
                ok = bool(torch.allclose(got, ref, rtol=1e-4, atol=1e-4))
                tm, tn, bk, st = plan
                rows.append({"kernel": "K1", "at": tag, "mode": "training" if train else "eval",
                             "step": step, "name": K1_STEP_NAMES[step],
                             "tile": [16 * tm, 16 * tn], "k_slice": bk, "stages": st,
                             "shipped": i == ship_i, "ok": ok, "ms": time_ms(run)})
            del a, w, out, ref


PARTS = ("k4", "k7", "k8", "k9", "k2steps", "k2gemm", "k2attn", "k1steps", "k1gemm")


def main() -> int:
    import torch
    from chip_smoke import gpu_line
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    parts = sys.argv[1:] or PARTS
    if any(p not in PARTS for p in parts):
        print(f"torch_kernel_sweep: parts are {', '.join(PARTS)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    gpu = gpu_line()
    rows = []
    if "k2steps" in parts or "k1steps" in parts:
        from recstudio_torch.ops import _native
        for ln in _native.load().ptxas_log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"PTXAS port: {ln.strip()}", flush=True)
        if "k2steps" in parts:
            k2_steps(device, rows)
    if "k1steps" in parts:
        k1_steps(device, rows)
    for row in rows:        # before the sweeps' build, which may fail
        print(f"PLAN {json.dumps({'gpu': gpu, **row})}", flush=True)
    ok, rows = all(r.get("ok", True) for r in rows), []
    if any(p in parts for p in ("k4", *CLSE_KERNELS, "k2gemm", "k2attn", "k1gemm")):
        t0 = time.perf_counter()
        libs, report = build(os.path.join(REPO, "build", "recstudio_torch", "sweep"), parts)
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
        for ln in report:
            print(f"PTXAS {ln}", flush=True)
        if "k4" in parts:
            sweep_k4(libs, device, rows)
        for part in CLSE_KERNELS:
            if part in parts:
                sweep_clse(libs, device, rows, part)
        if "k2gemm" in parts:
            sweep_k2_gemm(libs, device, rows)
        if "k2attn" in parts:
            sweep_k2_attn(libs, device, rows)
        if "k1gemm" in parts:
            sweep_k1_gemm(libs, device, rows)
    for row in rows:
        print(f"PLAN {json.dumps({'gpu': gpu, **row})}", flush=True)
    print(f"GPU {gpu_line()}", flush=True)
    return 0 if ok and all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
