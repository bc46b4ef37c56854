#!/usr/bin/env python3
"""Measure the FP64 tensor-core rate of each ``mma.sync`` float64 shape.

    python3 tools/dmma_shapes.py

Builds a small CUDA source (written under ``build/dmma_shapes/``) with
nvcc for ``sm_90a`` and times one kernel per shape, ``m8n8k4`` (the
Ampere shape) and ``m16n8k4`` / ``m16n8k8`` / ``m16n8k16`` (added for
sm_90): every warp of 4 blocks of 512 threads an SM runs 16 independent
accumulator chains through ``ITERS`` products from registers (no memory
traffic), and the rate is the shape's FLOPs over the CUDA-event time.
Prints one line per shape, the card's name and power limit, and a JSON
object.
"""

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ITERS = 2048
CHAINS = 8
BLOCKS_PER_SM = 2
THREADS = 512

# (shape, A registers, B registers, C registers, FLOPs a product)
SHAPES = (("m8n8k4", 1, 1, 2, 2 * 8 * 8 * 4),
          ("m16n8k4", 2, 1, 4, 2 * 16 * 8 * 4),
          ("m16n8k8", 4, 2, 4, 2 * 16 * 8 * 8),
          ("m16n8k16", 8, 4, 4, 2 * 16 * 8 * 16))


def kernel_source(shape: str, na: int, nb: int, nc: int) -> str:
    """One shape's kernel and its C launch entry."""
    outs = ", ".join(f"%{i}" for i in range(nc))
    a_ops = ", ".join(f"%{nc + i}" for i in range(na))
    b_ops = ", ".join(f"%{nc + na + i}" for i in range(nb))
    cons = ", ".join(f'"+d"(c[j][{i}])' for i in range(nc))
    ins = ", ".join([f'"d"(a[{i}])' for i in range(na)]
                    + [f'"d"(b[{i}])' for i in range(nb)])
    return f"""
__global__ void __launch_bounds__({THREADS})
rate_{shape}(double* out, double seed) {{
  double a[{na}], b[{nb}], c[{CHAINS}][{nc}];
  for (int i = 0; i < {na}; ++i) a[i] = seed * (threadIdx.x + i);
  for (int i = 0; i < {nb}; ++i) b[i] = seed * ((int)threadIdx.x - i);
  for (int j = 0; j < {CHAINS}; ++j)
    for (int i = 0; i < {nc}; ++i) c[j][i] = 0.0;
  for (int it = 0; it < {ITERS}; ++it) {{
#pragma unroll
    for (int j = 0; j < {CHAINS}; ++j)
      asm volatile("mma.sync.aligned.{shape}.row.col.f64.f64.f64.f64 "
                   "{{{outs}}}, {{{a_ops}}}, {{{b_ops}}}, {{{outs}}};\\n"
                   : {cons} : {ins});
  }}
  double s = 0.0;
  for (int j = 0; j < {CHAINS}; ++j)
    for (int i = 0; i < {nc}; ++i) s += c[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}}

extern "C" int launch_{shape}(void* out, double seed, int blocks,
                              void* stream) {{
  rate_{shape}<<<blocks, {THREADS}, 0, (cudaStream_t)stream>>>(
      (double*)out, seed);
  return (int)cudaGetLastError();
}}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dmma_shapes: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import card_line, time_ms
    from fakepta_tpu_torch.ops import _build

    out_dir = os.path.join(HERE, "build", "dmma_shapes")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "dmma_shapes.cu")
    with open(src, "w") as fh:
        fh.write("#include <cuda_runtime.h>\n"
                 + "".join(kernel_source(*s[:4]) for s in SHAPES))
    lib_path = os.path.join(out_dir, "dmma_shapes.so")
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for shape, _, _, _, flops in SHAPES:
        fn = getattr(lib, f"launch_{shape}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
                       ctypes.c_void_p]

        def launch(fn=fn):
            rc = fn(out.data_ptr(), 1e-3, blocks, stream)
            if rc:
                raise RuntimeError(f"{shape}: CUDA error {rc}")

        ms = time_ms(launch, 5)
        total = float(flops) * ITERS * CHAINS * (THREADS // 32) * blocks
        rows[shape] = {"ms": ms, "tflops": total / ms / 1e9}
        print(f"{shape}: {ms:.4f} ms, {rows[shape]['tflops']:.2f} TFLOP/s",
              flush=True)
    card = card_line()
    print(f"card: {card}")
    print(json.dumps({"card": card, "blocks": blocks, "threads": THREADS,
                      "iters": ITERS, "chains": CHAINS, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
