"""Serve a small model with batched requests: prefill + decode loop, on the
PyTorch/CUDA port.

Batched prefill fills the KV/SSM cache (attention through the flash kernel,
the Mamba-2 heads through the SSD chunk kernel), then each serve step
decodes one token per request.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode
  PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu
"""
import argparse

from repro_torch.launch import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    argv = ["--arch", args.arch, "--batch", "4", "--prompt-len", "64",
            "--tokens", str(args.tokens)]
    if args.device is not None:
        argv += ["--device", args.device]
    serve.main(argv)


if __name__ == "__main__":
    main()
