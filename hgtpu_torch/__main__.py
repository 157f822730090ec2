# Port of hgtpu/__main__.py: `python -m hgtpu_torch`.
import sys

from .cli.main import main

if __name__ == "__main__":
    sys.exit(main())
