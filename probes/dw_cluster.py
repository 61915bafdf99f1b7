"""K1-dW's reduction across chunks, with and without a thread-block
cluster, on one card.

``boosted_detr_torch/csrc/patchify.cu``'s tensor-core weight gradient
(``patchify_dw_mma_kernel``) writes one float32 partial a chunk and sums
the partials in a second pass. The alternative its header weighs: a
cluster of 2, 4 or 8 chunks of one dw tile sums its blocks' tiles in rank
order through distributed shared memory and writes one partial a cluster.
This script makes that variant from the source (``EDITS``, each of which
must match exactly once: they fit the kernel as it stood when the variant
was measured, and the script raises, rather than build something else,
once the kernel has changed), builds it with nvcc into
``build/probes/``, holds each cluster size's float32 sums against the
plain version under ``chip_smoke.py``'s K1-dW gate, and times it at the
three main shapes by ``chip_smoke.py``'s two methods (``ms``: from an idle
card, L2 flushed; ``device_ms``: the launch enqueued ahead of a spin on
the card), beside the committed kernel in the same process. Run on a card
from the root of a checkout:

    python3 probes/dw_cluster.py

It prints the card's name and power limit, the variant's ptxas report and
one JSON line a shape.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "boosted_detr_torch" / "csrc" / "patchify.cu"

_EPILOGUE = """\
  namespace cg = cooperative_groups;
  cg::cluster_group blocks = cg::this_cluster();
  __syncthreads();  // every warp is done with the pipeline's room
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int kt = 0; kt < DW_KW; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nb = 0; nb < DW_NW; ++nb)
        *reinterpret_cast<float2*>(
            tile + (kw0 + 16 * kt + grp + 8 * h) * DW_T_PITCH + nw0 + 8 * nb +
            2 * tig) = make_float2(acc[kt][nb][2 * h], acc[kt][nb][2 * h + 1]);
  blocks.sync();  // every block's tile is whole
  const int rank = static_cast<int>(blocks.block_rank());
  const int slice = DW_KT / cluster;  // k rows this block sums
  float* out = partial + static_cast<long long>(blockIdx.y / cluster) * K * N;
  for (int e = tid; e < slice * (DW_NT / 4); e += THREADS) {
    const int kk = rank * slice + e / (DW_NT / 4), nn = 4 * (e % (DW_NT / 4));
    const int at = kk * DW_T_PITCH + nn;
    float4 s =
        *reinterpret_cast<const float4*>(blocks.map_shared_rank(tile, 0) + at);
    for (int j = 1; j < cluster; ++j) {  // in rank order: deterministic
      const float4 v = *reinterpret_cast<const float4*>(
          blocks.map_shared_rank(tile, j) + at);
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    if (k0 + kk < K && n0 + nn < N)
      *reinterpret_cast<float4*>(
          out + static_cast<long long>(k0 + kk) * N + n0 + nn) = s;
  }
  blocks.sync();  // no block leaves while another reads its tile
"""

_LAUNCH = """\
  const int tiles = (K + DW_KT - 1) / DW_KT * ((N + DW_NT - 1) / DW_NT);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles, chunks);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = 1;
  attribute[0].val.clusterDim.y = cluster;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, patchify_dw_mma_kernel, x, g, partial, H,
                           W, C, P, N, Ho, Wo, batch * Ho, R, seg, per_chunk,
                           cluster, clip01);
  if (err != cudaSuccess) return err;
"""

# (committed text, the variant's text): a `cluster` argument from the C
# entry point down to the kernel; chunks in groups of `cluster` write one
# partial a group, [chunks / cluster, K, N]; with a cluster the float32
# tile [DW_KT][DW_T_PITCH] reuses the pipeline's shared memory.
EDITS = (
    ('#include "mma.cuh"\n',
     '#include "mma.cuh"\n#include <cooperative_groups.h>\n'),
    ("constexpr int DW_G_PITCH = DW_NT + 8;",
     "constexpr int DW_T_PITCH = DW_NT + 4;\n"
     "constexpr int DW_G_PITCH = DW_NT + 8;"),
    ("int seg) {\n  return 2LL * 4 * dw_mma_raw_floats(P, C, R, seg) +",
     "int seg, int cluster) {\n"
     "  const long long tile = cluster > 1 ? 4LL * DW_KT * DW_T_PITCH : 0;\n"
     "  const long long pipeline = 2LL * 4 * dw_mma_raw_floats(P, C, R, seg) +"),
    ("4LL * 2 * DW_STAGE + 4LL * DW_CHUNKS;\n}",
     "4LL * 2 * DW_STAGE + 4LL * DW_CHUNKS;\n"
     "  return pipeline > tile ? pipeline : tile;\n}"),
    ("int seg, int per_chunk, int clip01) {",
     "int seg, int per_chunk, int cluster, int clip01) {"),
    ("  float* dst = partial + static_cast<long long>(blockIdx.y) * K * N;\n",
     "  if (cluster <= 1) {\n"
     "  float* dst = partial + static_cast<long long>(blockIdx.y) * K * N;\n"),
    ("}\n\ncudaError_t launch_dw_mma(",
     "  return;\n  }\n" + _EPILOGUE + "}\n\ncudaError_t launch_dw_mma("),
    ("int chunks, int per_chunk, int clip01,\n"
     "                          long long smem, cudaStream_t stream) {",
     "int chunks, int per_chunk, int cluster, int clip01,\n"
     "                          long long smem, cudaStream_t stream) {"),
    ("  const dim3 grid((K + DW_KT - 1) / DW_KT * ((N + DW_NT - 1) / DW_NT), "
     "chunks);\n"
     "  patchify_dw_mma_kernel<<<grid, THREADS, static_cast<size_t>(smem), "
     "stream>>>(\n"
     "      x, g, partial, H, W, C, P, N, Ho, Wo, batch * Ho, R, seg, "
     "per_chunk,\n      clip01);\n",
     _LAUNCH),
    ("0, stream>>>(partial, chunks, KN, dw32,",
     "0, stream>>>(partial, chunks / cluster, KN, dw32,"),
    ("                    int clip01, long long smem_bytes,\n",
     "                    int cluster, int clip01, long long smem_bytes,\n"),
    ("      chunks > 65535 ||\n",
     "      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||\n"
     "      chunks % cluster != 0 || chunks > 65535 ||\n"),
    ("smem_bytes != dw_mma_smem(P, C, R, seg))",
     "smem_bytes != dw_mma_smem(P, C, R, seg, cluster))"),
    ("      per_chunk, clip01, smem_bytes,\n",
     "      per_chunk, cluster, clip01, smem_bytes,\n"),
)

# the three main shapes: (image side, patch, channels, chip_smoke's seed)
SHAPES = ((640, 8, 128, 4), (1280, 8, 128, 31), (640, 16, 384, 7))
CLUSTERS = (1, 2, 4, 8)


def variant_source() -> str:
    """The committed source with ``EDITS`` made; raises where one does not
    match exactly once."""
    src = SOURCE.read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"{SOURCE.name} has {src.count(old)} matches "
                               f"of the edit starting {old[:50]!r}")
        src = src.replace(old, new)
    return src


def _build_variant() -> Path:
    from boosted_detr_torch.ops import build

    out_dir = build.BUILD_DIR.parent / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "patchify_dw_cluster.cu"
    cu.write_text(variant_source())
    lib = out_dir / "libpatchify_dw_cluster.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "dw_mma_kernel" in line:
            print("variant's ptxas:", *(s.strip() for s in lines[i + 1:i + 5]
                                        if "spill" in s or "registers" in s))
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dw_cluster: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from boosted_detr_torch.ops import patchify as tp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    fn = ctypes.CDLL(str(_build_variant())).patchify_dw_mma
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 14
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    bf16 = torch.bfloat16
    for res, patch, c_out, seed in SHAPES:
        x, g = cs._dw_inputs(patch, c_out, bf16, seed, res)
        b, h, w, c = x.shape
        k = patch * patch * c
        plan = tp.dw_tensor_core_plan(tuple(x.shape), tuple(g.shape), patch,
                                      bf16)
        _, ref32 = tp.patchify_conv_dw_reference(x, g, patch, bf16,
                                                 clip01=True)
        patches, _ = tp._patch_matrix(x, patch, bf16, True)
        scale = (patches.float().abs().t()
                 @ g.reshape(-1, c_out).float().abs()).reshape(ref32.shape)
        bound = 1e-5 * scale + 1e-6  # the chip's K1-dW gate on the sums

        def committed():
            return tp.patchify_conv_dw(x, g, patch, bf16, clip01=True)

        row = {"shape": cs._dw_label(patch, c_out, bf16, res),
               "plan": plan._asdict(),
               "committed": {
                   "ms": cs._time_ms(committed, flush),
                   "device_ms": cs._time_ms(committed, flush,
                                            spin_cycles=cs.SPIN_CYCLES)}}
        for cluster in CLUSTERS:
            chunks = -(-plan.chunks // cluster) * cluster
            smem = (plan.smem if cluster == 1 else max(
                plan.smem, 4 * tp.DW_MMA_TILE_K * (tp.DW_MMA_TILE_N + 4)))
            partial = torch.empty((chunks // cluster, k, c_out),
                                  dtype=torch.float32, device="cuda")
            dw32 = torch.empty((k, c_out), dtype=torch.float32,
                               device="cuda")
            dw = torch.empty((k, c_out), dtype=bf16, device="cuda")

            def variant():
                rc = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                        dw32.data_ptr(), dw.data_ptr(), b, h, w, c, patch,
                        c_out, h // patch, w // patch, plan.rows, plan.seg,
                        chunks, plan.per_chunk, cluster, 1, smem,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"cluster {cluster}: launch failed "
                                       f"({rc})")

            variant()
            torch.cuda.synchronize()
            err = (dw32.reshape(ref32.shape) - ref32).abs()
            if not (err <= bound).all():
                raise AssertionError(f"{row['shape']}, cluster {cluster}: "
                                     f"off the plain version")
            row[f"cluster_{cluster}"] = {
                "chunks": chunks, "max_abs_err": err.max().item(),
                "ms": cs._time_ms(variant, flush),
                "device_ms": cs._time_ms(variant, flush,
                                         spin_cycles=cs.SPIN_CYCLES)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
