"""`python -m snappydata_tpu_torch ...`: the CLI (cli.py).  A member's
device is its `--device` flag (cuda by default), not an environment
variable."""

from snappydata_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
