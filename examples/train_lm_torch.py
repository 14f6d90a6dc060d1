"""End-to-end LM training on the PyTorch port (``examples/train_lm.py``'s
counterpart): a small llama-family model for a few hundred steps through
the whole training stack: synthetic data with prefetch, AdamW with a
cosine schedule, remat, microbatch accumulation, async checkpoints,
resume and the straggler watchdog.

Default: a ~13M-parameter model; ``--scale 100m`` a ~100M one (the same
code path).  Runs on the card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \\
          [--scale 100m] [--device cpu]
"""
import argparse
import sys


def main():
    from repro_torch.launch.train import main as train_main
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scale", default="13m", choices=["13m", "100m"])
    ap.add_argument("--ckpt-dir", default="build/train_lm_torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    argv = ["--arch", "tinyllama-1.1b", "--reduced",
            "--steps", str(args.steps), "--batch", "8", "--seq", "256",
            "--lr", "1e-3", "--microbatches", "2", "--remat", "dots",
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
            "--log-every", "20", "--device", args.device]
    if args.scale == "100m":
        argv += ["--override", "num_layers=12", "--override", "d_model=768",
                 "--override", "num_heads=12", "--override", "num_kv_heads=4",
                 "--override", "d_ff=2048", "--override", "vocab_size=32000"]
    else:
        argv += ["--override", "num_layers=6", "--override", "d_model=384",
                 "--override", "num_heads=6", "--override", "num_kv_heads=2",
                 "--override", "d_ff=1024", "--override", "vocab_size=8192"]
    raise SystemExit(train_main(argv))


if __name__ == "__main__":
    sys.path.insert(0, "src")
    main()
