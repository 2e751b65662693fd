"""Batched serving on the PyTorch port: prompts stream OUT of a Deep Lake
dataset, responses stream back IN (the paper's §3.5 'models storing back
predictions along with the dataset' access pattern), under version control.
Decodes on the CUDA device (``--device cpu`` for the CPU).

    PYTHONPATH=src python examples/torch_serve_batched.py
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu --steps 4
"""

import argparse

import numpy as np

import repro_torch.core as dl
from repro_torch.launch.serve import Server, ServeJob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=12,
                    help="tokens generated a request")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    job = ServeJob(arch="starcoder2-3b", smoke=True, batch=4, prompt_len=12,
                   max_new_tokens=args.steps, temperature=0.8,
                   device=args.device)
    server = Server(job)

    # request store: a Deep Lake dataset of prompts
    ds = dl.dataset()
    ds.create_tensor("prompt", htype="tokens", dtype="int32")
    ds.create_tensor("response", htype="tokens", dtype="int32", strict=False)
    for _ in range(args.requests):
        ds.prompt.append(rng.integers(0, server.cfg.vocab_size,
                                      job.prompt_len).astype(np.int32))
    ds.commit("requests")

    # serve in fixed-size batches
    for start in range(0, len(ds.prompt), job.batch):
        idx = list(range(start, min(start + job.batch, len(ds.prompt))))
        prompts = np.stack([ds.prompt[i] for i in idx])
        out = server.generate(prompts)
        for row_i, i in enumerate(idx):
            ds.response[i] = out[row_i, job.prompt_len:].astype(np.int32)
    ds.commit("responses")

    print(f"served {len(ds.prompt)} requests | "
          f"decode throughput {server.throughput():.1f} tok/s "
          f"({server.device.type})")
    print("sample response ids:", ds.response[0][:10].tolist())
    print("dataset log:", [n.message for n in ds.log()])
    return ds


if __name__ == "__main__":
    main()
