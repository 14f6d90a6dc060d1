"""Batched serving on the PyTorch port (``examples/serve_lm.py``'s
counterpart): a reduced decoder-only LM serving a queue of requests
through the BatchEngine (fixed decode slots, slot recycling, greedy
sampling), with the reference walkthrough's arguments.

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it exits non-zero: it never falls back.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    from repro_torch.launch.serve import main as serve_main
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    raise SystemExit(serve_main([
        "--arch", "qwen2.5-3b", "--reduced", "--requests", "6",
        "--slots", "3", "--prompt-len", "10", "--max-new", "12",
        "--cache-len", "64", "--device", args.device]))


if __name__ == "__main__":
    sys.path.insert(0, "src")
    main()
