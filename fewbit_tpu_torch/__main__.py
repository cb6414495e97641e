import sys

from fewbit_tpu_torch.cli import main

sys.exit(main())
