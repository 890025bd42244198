"""Parallelism on ``torch.distributed`` (counterpart of
``opentransformer_tpu/parallel/``): the mesh and its sharding rules
(``mesh``), the launcher (``launch``), tensor and expert parallelism of the
model's modules (``tensor``), the trainer's side of a mesh (``engine``) and
the pipeline schedules (``pipeline``). The collectives with gradients that
the models and losses call are ``ops/collectives.py``, one layer down: the
models import nothing of this package, which sets the groups on them.
"""

from .mesh import (  # noqa: F401
    DEFAULT_RULES,
    Mesh,
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
)
