"""End-to-end driver on the PyTorch port: train a qwen2-family LM with the
full stack — data pipeline → train step → async checkpointing → restart.

``examples/train_lm.py`` on ``repro_torch.launch.train`` (the launcher this
script calls), on the CUDA card unless ``--device`` names another device
(without a card it raises unless ``--device cpu`` is passed).

Run: PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \\
         [--device cpu]

At the default 200 steps the loss drops well below where it started; the
script "crashes" at 60 % of the steps, restarts from the checkpoint, and
shows the loss curve continuing exactly (fault-tolerance demo).
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import train as train_mod   # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    return ap.parse_args(argv)


def crash_and_resume(args):
    """Phase 1 trains to 60 % of ``--steps`` and stops; phase 2 resumes
    from the checkpoint and finishes the run.  Returns both runs' results."""
    shutil.rmtree(args.ckpt, ignore_errors=True)
    crash_at = max(args.steps * 6 // 10, 2)
    base = ["--arch", "qwen2-7b", "--reduced",
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt-dir", args.ckpt, "--ckpt-every", "20",
            "--log-every", "20"] + (["--device", args.device]
                                    if args.device else [])

    print(f"=== phase 1: train to step {crash_at}, then 'crash' ===")
    r1 = train_mod.main(base + ["--steps", str(crash_at)])

    print("\n=== phase 2: restart from the checkpoint, finish the run ===")
    r2 = train_mod.main(base + ["--steps", str(args.steps), "--resume"])
    return r1, r2


def main(argv=None):
    args = parse(argv)
    r1, r2 = crash_and_resume(args)
    # the restart resumed from the last checkpoint BEFORE the crash, so the
    # first resumed losses replay the same (step-addressed) batches
    crash_at = max(args.steps * 6 // 10, 2)
    print("\n=== summary ===")
    print(f"phase-1 final loss {r1['losses'][-1]:.4f} at step {crash_at - 1}")
    print(f"phase-2 resumed at step {r2['start_step']}, "
          f"final loss {r2['losses'][-1]:.4f}")
    assert r2["losses"][-1] < r1["losses"][0] * 0.8, "no learning?"
    print("loss decreased end-to-end across the restart  ✓")
    return r1, r2


if __name__ == "__main__":
    main()
