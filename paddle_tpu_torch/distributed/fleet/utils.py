"""``fleet.utils`` (the port of
``paddle_tpu/distributed/fleet/utils.py``): ``recompute``,
``fused_allreduce_gradients`` and ``LocalFS``.

The reference's ``fused_allreduce_gradients`` does nothing because its
gradients come out of a compiled step already reduced.  Here each rank
holds its own, so it is the data-parallel average: the gradients
summed over the ``dp`` group in buckets and divided by the group size
(``parallel.average_gradients``).  It is idempotent as
``DataParallel.apply_collective_grads`` is: gradients averaged since
their last backward (by a ``DataParallel`` hook or an earlier call) are
left as they are.
"""
from __future__ import annotations

import os
import shutil

from ..recompute import recompute, recompute_sequential  # noqa: F401

__all__ = ["recompute", "recompute_sequential",
           "fused_allreduce_gradients", "LocalFS"]


def fused_allreduce_gradients(parameter_list, hcg=None):
    """Average the gradients of ``parameter_list`` over ``hcg``'s ``dp``
    group (the topology's without ``hcg``), leaving those already
    averaged since their last backward (``parallel.average_gradients``)."""
    from ..mesh import get_topology
    from ..parallel import average_gradients
    topo = hcg if hcg is not None else get_topology(create=False)
    if topo is not None:
        average_gradients(list(parameter_list), topo.group("dp"))


class LocalFS:
    """Paddle's ``fleet/utils/fs.py`` ``LocalFS`` over the local file
    system."""

    def ls_dir(self, path):
        entries = os.listdir(path)
        dirs = [e for e in entries if os.path.isdir(os.path.join(path, e))]
        files = [e for e in entries
                 if os.path.isfile(os.path.join(path, e))]
        return dirs, files

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
