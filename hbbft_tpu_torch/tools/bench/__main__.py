"""``python -m hbbft_tpu_torch.tools.bench``: see the package docstring."""

import sys

from hbbft_tpu_torch.tools.bench import main

sys.exit(main())
