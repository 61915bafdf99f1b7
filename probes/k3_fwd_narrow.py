"""Design variants of K3's bf16 forward at D = 80 and 128, on one card.

``boosted_detr_torch/csrc/attention.cu``'s ``attn_fwd_wgmma_kernel<D>`` runs,
a 64-key tile at a time, S = q k^T on wgmma, the online softmax on the CUDA
cores and P.V on wgmma (p's hi, then lo), with TMA loads of k and v into
two stages that carry both. This script makes variants of the source by
the exact-match edits of ``VARIANTS`` (each must match once: they fit the
kernel as it stood when these were measured, and the script raises, rather
than build something else, once the kernel has changed), builds each with
nvcc into ``build/probes/`` (all at once), and times it beside the
committed kernel in the same process by ``chip_smoke.py``'s ``device_ms``
(the launch enqueued ahead of a spin on the card, the L2 flushed):

  - ``shipped``: the committed kernel (two blocks an SM, 128 registers a
    thread);
  - ``one_block``: one block an SM (255 registers a thread allowed);
  - ``overlap``: tile i + 1's S issued as a commit group of its own before
    tile i's softmax, so that the tensor cores compute it while the CUDA
    cores run the softmax; k and v in rings of their own (a k stage is
    released once its S is done, a v stage once its P.V is), the tiles
    taken two at a time so that the two S buffers keep their registers,
    and k tile n_tiles (TMA's zeros) loaded so that every S is issued
    without a branch. One block an SM (two S buffers pass 128 registers).

Every variant is held against ``attention_fwd_emulation`` (the share of
equal bf16 values, the lse's largest difference) and against the shipped
kernel's bits, at the timed shapes and at ragged ones. Run on a card from
the root of a checkout:

    python3 probes/k3_fwd_narrow.py

It prints the card's name and power limit, each variant's ptxas registers,
spills and serialisation notes for the forward, and one JSON line a
variant and shape.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "boosted_detr_torch" / "csrc" / "attention.cu"
OUT = ROOT / "build" / "probes"
FWD = "attn_fwd_wgmma_kernelILi"

_BLOCKS = "__launch_bounds__(NARROW_THREADS, 2)\nattn_fwd_wgmma_kernel("
_ONE_BLOCK = "__launch_bounds__(NARROW_THREADS, 1)\nattn_fwd_wgmma_kernel("
_KERNEL_START = """template <int D>
__global__ void __launch_bounds__(NARROW_THREADS, 2)
attn_fwd_wgmma_kernel("""
_KERNEL_END = "\n// dq at D = 80 and 128:"
_OVERLAP = r"""template <int D>
__global__ void __launch_bounds__(NARROW_THREADS, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      int Tq, int Tk, int tiles, float scale) {
  constexpr int STEPS = TILE / STEP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t q_full, k_full[2], k_empty[2], v_full[2], v_empty[2];
  unsigned char* sq = swizzle_aligned(smem_raw);
  unsigned char* sk = sq + NARROW_WGS * NTILE_BYTES;
  unsigned char* sv = sk + 2 * NTILE_BYTES;
  const int bh = blockIdx.x / tiles;
  const int first = (blockIdx.x % tiles) * NARROW_ROWS;
  const int n_tiles = (Tk + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    barrier_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      barrier_init(&k_full[s], 1);
      barrier_init(&k_empty[s], 4 * NARROW_WGS);
      barrier_init(&v_full[s], 1);
      barrier_init(&v_empty[s], 4 * NARROW_WGS);
    }
    barrier_init_fence();
  }
  __syncthreads();
  auto load_k = [&](int i) {
    const int st = i % 2;
    barrier_expect_bytes(&k_full[st], NTILE_BYTES);
    for (int s = 0; s < 2; ++s)
      tma_load_3d(sk + st * NTILE_BYTES + s * SLAB_BYTES, &k_map,
                  &k_full[st], s * SLAB, i * TILE, bh);
  };
  auto load_v = [&](int i) {
    const int st = i % 2;
    barrier_expect_bytes(&v_full[st], NTILE_BYTES);
    for (int s = 0; s < 2; ++s)
      tma_load_3d(sv + st * NTILE_BYTES + s * SLAB_BYTES, &v_map,
                  &v_full[st], s * SLAB, i * TILE, bh);
  };
  if (threadIdx.x == 0) {
    barrier_expect_bytes(&q_full, NARROW_WGS * NTILE_BYTES);
    for (int w = 0; w < NARROW_WGS; ++w)
      for (int s = 0; s < 2; ++s)
        tma_load_3d(sq + w * NTILE_BYTES + s * SLAB_BYTES, &q_map, &q_full,
                    s * SLAB, first + w * TILE, bh);
    for (int i = 0; i < 2 && i <= n_tiles; ++i) load_k(i);
    for (int i = 0; i < 2 && i < n_tiles; ++i) load_v(i);
  }
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int r0 = first + wg * TILE + warp * STEP + grp;
  const long long q_base = static_cast<long long>(bh) * Tq;
  const unsigned char* q_rows = sq + wg * NTILE_BYTES;
  const float scale2 = scale * LOG2E;
  float m[2] = {NEG, NEG}, denom[2] = {0.f, 0.f};
  float acc[D / 8][4];
  float(&acc_flat)[D / 2] = reinterpret_cast<float(&)[D / 2]>(acc);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_flat[i] = 0.f;
  float sa[32], sb[32];
  auto issue_s = [&](float (&x)[32], int i) {
    const int st = i % 2;
    barrier_wait(&k_full[st], (i / 2) & 1);
    wgmma_fence();
    wgmma_over_dims<D>(x, q_rows, sk + st * NTILE_BYTES);
    wgmma_commit();
  };
  auto tile = [&](float (&x)[32], float (&next)[32], int i) {
    issue_s(next, i + 1);  // k tile n_tiles is TMA's zeros, its S unused
    wgmma_wait<1>();       // S of tile i and P.V of tile i - 1 are done
    wgmma_hold(x);
    wgmma_hold(acc_flat);
    if (lane == 0) {
      barrier_arrive(&k_empty[i % 2]);
      if (i > 0) barrier_arrive(&v_empty[(i - 1) % 2]);
    }
    if (threadIdx.x == 0) {
      if (i + 2 <= n_tiles) {
        barrier_wait(&k_empty[i % 2], (i / 2) & 1);
        load_k(i + 2);
      }
      if (i > 0 && i + 1 < n_tiles) {
        barrier_wait(&v_empty[(i - 1) % 2], ((i - 1) / 2) & 1);
        load_v(i + 1);
      }
    }
    __syncwarp();
    float(&s)[STEPS][2][4] = reinterpret_cast<float(&)[STEPS][2][4]>(x);
    const int k0 = i * TILE;
    const bool ragged = k0 + TILE > Tk;
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + cs * STEP + 8 * j + 2 * tig + e % 2;
          if (ragged && key >= Tk) s[cs][j][e] = NEG;
          m_new[e / 2] = fmaxf(m_new[e / 2], s[cs][j][e]);
        }
    float alpha[2], shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      alpha[h] = exp2_approx((m[h] - m_new[h]) * scale2);
      shift[h] = m_new[h] * scale2;
      m[h] = m_new[h];
      denom[h] *= alpha[h];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e / 2];
    uint32_t hi[STEPS][4], lo[STEPS][4];
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[cs][j][e], scale2, -shift[e / 2]));
          s[cs][j][e] = p;
          denom[e / 2] += p;
        }
      split_fragment(s[cs], hi[cs], lo[cs]);
    }
    const int vs = i % 2;
    barrier_wait(&v_full[vs], (i / 2) & 1);
    wgmma_hold(acc_flat);
    wgmma_fence();
    wgmma_over_rows<D>(acc_flat, hi, lo, sv + vs * NTILE_BYTES);
    wgmma_commit();
  };
  barrier_wait(&q_full, 0);
  issue_s(sa, 0);
  for (int i = 0; i < n_tiles; i += 2) {
    tile(sa, sb, i);
    if (i + 1 < n_tiles) tile(sb, sa, i + 1);
  }
  wgmma_wait<0>();
  wgmma_hold(acc_flat);
  wgmma_hold(sa);
  wgmma_hold(sb);
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 1);
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 2);
    denom[h] = fmaxf(denom[h], FLOOR);
    inv[h] = 1.f / denom[h];
    if (tig == 0 && r0 + 8 * h < Tq)
      lse[q_base + r0 + 8 * h] = m[h] * scale + logf(denom[h]);
  }
  store_accumulator<D>(acc, inv, out + q_base * D, r0, Tq, tig);
}
"""
VARIANTS = {
    "shipped": (),
    "one_block": ((_BLOCKS, _ONE_BLOCK),),
    "overlap": ("overlap",),
}
# (BH, Tq, Tk, D): vit_h16's blocks, vit_w512_h4's at batch 8 (timed), and
# ragged shapes (checked only)
TIMED = ((128, 1600, 1600, 80), (32, 1600, 1600, 128))
RAGGED = ((2, 130, 70, 80), (2, 130, 70, 128), (3, 17, 1000, 80),
          (3, 520, 17, 128))


def _variant(edits) -> str:
    text = SOURCE.read_text()
    for edit in edits:
        if edit == "overlap":
            start = text.index(_KERNEL_START)
            end = text.index(_KERNEL_END, start)
            text = text[:start] + _OVERLAP + text[end:]
            continue
        old, new = edit
        if text.count(old) != 1:
            raise RuntimeError(f"the kernel has changed: an edit matches "
                               f"{text.count(old)} times, not once:\n{old}")
        text = text.replace(old, new)
    return text


def _build(name: str, text: str):
    """(the library, its ptxas lines for the forward) of one variant."""
    from boosted_detr_torch.ops import build

    src = OUT / f"k3_fwd_narrow_{name}.cu"
    lib = OUT / f"libk3_fwd_narrow_{name}.so"
    src.write_text(text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(SOURCE.parent), "-o", str(lib), str(src)],
                          capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    (OUT / f"libk3_fwd_narrow_{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
    notes, entry = [], None
    for line in log.splitlines():
        found = re.search(rf"Compiling entry function '\S*{FWD}(\d+)", line)
        if found:
            entry = f"D={found.group(1)}"
        elif "Compiling entry" in line:
            entry = None
        if entry and ("registers" in line or "spill" in line):
            notes.append(f"  {name} {entry}: {line.strip()}")
        if FWD in line and "Potential Performance Loss" in line:
            notes.append(f"  {name}: " + line.split(
                "Potential Performance Loss: ")[1].split(" in the function")[0])
    return lib, notes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_fwd_narrow: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from boosted_detr_torch.ops import attention as A

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    texts = {name: _variant(edits) for name, edits in VARIANTS.items()}
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda kv: _build(*kv),
                                         texts.items())))
    libs = {}
    for name, (path, notes) in built.items():
        print("\n".join(notes), flush=True)
        lib = ctypes.CDLL(str(path))
        lib.attention_fwd.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 5
                                      + [ctypes.c_float, ctypes.c_void_p])
        lib.attention_fwd.restype = ctypes.c_int
        libs[name] = lib
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(700)
    for bh, tq, tk, d in TIMED + RAGGED:
        q, k, v = (torch.randn((bh, t, d), generator=gen, device="cuda")
                   .bfloat16() for t in (tq, tk, tk))
        out = torch.empty_like(q)
        lse = torch.empty((bh, tq), device="cuda")

        def launch(lib):
            rc = lib.attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), bh, tq, tk, d, 1, A._scale(d),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        want, want_lse = A.attention_fwd_emulation(q, k, v)
        shipped = None
        for name, lib in libs.items():
            out.zero_()
            launch(lib)
            torch.cuda.synchronize()
            row = {"variant": name, "shape": [bh, tq, tk, d],
                   "equal_to_emulation":
                       (out == want).float().mean().item(),
                   "lse_max_diff": (lse - want_lse).abs().max().item()}
            if shipped is None:
                shipped = (out.clone(), lse.clone())
            else:
                row["bits_of_shipped"] = bool(torch.equal(out, shipped[0])
                                              and torch.equal(lse,
                                                              shipped[1]))
            if (bh, tq, tk, d) in TIMED:
                row["device_ms"] = cs._time_ms(lambda: launch(lib), flush,
                                               spin_cycles=cs.SPIN_CYCLES)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
