"""CLI entry point: ``python -m repro_torch.analysis [paths]``."""
from repro_torch.analysis.core import main

if __name__ == "__main__":
    raise SystemExit(main())
