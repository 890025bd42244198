#!/usr/bin/env python
"""Checkpoint averaging on the PyTorch port (``tools/average.py`` is the JAX
package's): ``python tools/torch_average.py EXPDIR START END``."""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from opentransformer_tpu_torch.cli.average import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
