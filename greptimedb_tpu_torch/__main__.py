import sys

from greptimedb_tpu_torch.cli import main

sys.exit(main())
