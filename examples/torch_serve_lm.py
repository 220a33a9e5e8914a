"""Serving example on the PyTorch port: batched prefill + decode with
continuous batching.

``examples/serve_lm.py`` on ``repro_torch.launch.serve``: the reduced
yi-9b, 8 requests over 4 slots, 8 new tokens each.  It serves on the CUDA
card unless ``--device`` names another device (without a card it raises
unless ``--device cpu`` is passed).  Reports TTFT and per-token latency.

Run: PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import serve as serve_mod   # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = serve_mod.main([
        "--arch", "yi-9b", "--reduced",
        "--requests", "8", "--slots", "4", "--max-new", "8",
    ] + (["--device", args.device] if args.device else []))
    assert out["decode_steps"] > 0
    print("continuous-batching serve loop OK  ✓")
    return out


if __name__ == "__main__":
    main()
