import sys

from .cmd.compute import main

if __name__ == "__main__":
    sys.exit(main())
