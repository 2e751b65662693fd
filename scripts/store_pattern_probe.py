#!/usr/bin/env python3
"""How the order of a kernel's float4 stores sets its write rate on the card.

Run on a machine with a CUDA card, from the root of a checkout:

    python3 scripts/store_pattern_probe.py

Two write-only kernels fill the crop-normalize kernel's output at the image
feed's batch (256 x 224 x 224 x 3 fp32, 154 MB) with four float4 stores a
thread a pass, from a grid of 4 blocks of 256 threads an SM:

* ``per_thread``: a thread's four stores are 64 contiguous bytes of its own,
  so one store instruction of a warp touches 32 sectors and fills half of
  each (the first design of the crop-normalize kernel stored so);
* ``per_warp``: lane l of a warp stores quad l, then l + 32, ..., so one
  store instruction writes 512 contiguous bytes, whole sectors (the final
  design).

It prints the card's name and power limit and ``[store_pattern_probe]
{...}`` with each kernel's ms (CUDA events over 200 launches, after a warm
up) and the bytes written.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// quads: float4s to write; each thread writes 4 a pass
__global__ void per_thread(float4* out, int64_t quads) {
  const int64_t stride = 4ll * gridDim.x * blockDim.x;
  for (int64_t q = 4ll * (blockIdx.x * blockDim.x + threadIdx.x); q < quads;
       q += stride)
    for (int u = 0; u < 4; ++u)
      if (q + u < quads) out[q + u] = make_float4(u, u, u, u);
}

__global__ void per_warp(float4* out, int64_t quads) {
  const int64_t stride = 4ll * gridDim.x * blockDim.x;
  for (int64_t q = 4ll * blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += stride)
    for (int u = 0; u < 4; ++u)
      if (q + u * blockDim.x < quads)
        out[q + u * blockDim.x] = make_float4(u, u, u, u);
}

extern "C" int store_probe(int which, void* out, long long quads,
                           void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto s = static_cast<cudaStream_t>(stream);
  if (which == 0)
    per_thread<<<4 * sms, 256, 0, s>>>(static_cast<float4*>(out), quads);
  else
    per_warp<<<4 * sms, 256, 0, s>>>(static_cast<float4*>(out), quads);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("store_pattern_probe: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = _build.BUILD_DIR / "store_pattern_probe.cu"
    source.write_text(SOURCE)
    lib = _build.load(source)
    lib.store_probe.restype = ctypes.c_int
    lib.store_probe.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_void_p]
    out = torch.empty((256, 224, 224, 3), dtype=torch.float32, device="cuda")
    quads = out.numel() // 4
    stream = torch.cuda.current_stream().cuda_stream
    result = {"bytes": out.numel() * 4, "card": smi}
    for which, name in ((0, "per_thread"), (1, "per_warp"),
                        (0, "per_thread_again"), (1, "per_warp_again")):
        out.zero_()
        for _ in range(10):
            assert lib.store_probe(which, out.data_ptr(), quads, stream) == 0
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(200):
            lib.store_probe(which, out.data_ptr(), quads, stream)
        end.record()
        torch.cuda.synchronize()
        k = torch.arange(quads, device="cuda")    # quad k holds its u
        want = k % 4 if which == 0 else k % 1024 // 256
        if not torch.equal(out.view(-1, 4)[:, 0], want.float()):
            raise AssertionError(f"{name} did not write every quad once")
        result[f"{name}_ms"] = start.elapsed_time(end) / 200
    print("[store_pattern_probe] " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
