"""``python -m repro_torch.analysis`` — run the port's RSA linter (see
lint.py)."""
import sys

from .lint import main

if __name__ == "__main__":
    sys.exit(main())
