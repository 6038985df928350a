"""End-to-end training driver: the ~100M-parameter smollm variant, run
to the midpoint with checkpoints, then resumed (`--resume auto`) to the
end.  Exits 1 unless the loss fell.

The port of `examples/train_lm.py`:

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
        [--device cpu]
"""
import argparse
import sys
import tempfile

from repro_torch.launch import train as train_driver


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    common = ["--arch", "smollm-360m", "--variant", "train_100m",
              "--seq", str(args.seq), "--batch", str(args.batch),
              "--device", args.device]
    with tempfile.TemporaryDirectory() as ckpt:
        # phase 1: train to the midpoint, checkpointing
        first = train_driver.main(common + [
            "--steps", str(args.steps // 2), "--ckpt-dir", ckpt,
            "--ckpt-every", "25"])
        # phase 2: resume from the checkpoint and finish — proves the
        # restart path end to end (same data order, loss continuous)
        result = train_driver.main(common + [
            "--steps", str(args.steps), "--ckpt-dir", ckpt,
            "--resume", "auto"])
    ok = result["last_loss"] < result["first_loss"]
    print(f"loss {result['first_loss']:.3f} -> {result['last_loss']:.3f} "
          f"({'improved' if ok else 'NO IMPROVEMENT'})")
    return {"first": first, "resumed": result, "improved": ok}


if __name__ == "__main__":
    sys.exit(0 if main()["improved"] else 1)
