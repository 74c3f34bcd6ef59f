"""`python -m lightgbm_tpu_torch config=train.conf` (ref: src/main.cpp:14)."""
import sys

from .cli import main

sys.exit(main())
