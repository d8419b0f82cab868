"""One rank of a fleet role's world that shares rank 0's decisions and a
publish's leaves (``fleet.runner.RoleWorld``), run by
``tests/test_torch_gpu.py`` on two cards (not collected)::

    WORLD_SIZE=2 RANK=r LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_role_nccl_case.py [BACKEND]

BACKEND defaults to ``init_distributed``'s choice (NCCL, one card a rank);
``gloo`` runs the same on the CPU. Rank 0 decides, tells the other rank
twice that its wait goes on, then sends leaves of several dtypes and sizes
(one empty); every rank checks what it holds against the leaves it would
have loaded, and prints ``OK <backend>``.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from trlx_tpu_torch.fleet.runner import RoleWorld  # noqa: E402
from trlx_tpu_torch.parallel.mesh import init_distributed, make_mesh, peek_mesh, set_mesh  # noqa: E402


def leaves():
    rng = np.random.default_rng(7)
    return [rng.standard_normal((64, 33)).astype(np.float32), rng.integers(-128, 128, (4097,), dtype=np.int8),
            np.zeros((0, 5), dtype=np.float32), rng.integers(0, 2 ** 16, (3, 7, 11), dtype=np.uint16)]


def main():
    init_distributed(sys.argv[1] if len(sys.argv) > 1 else None)
    set_mesh(make_mesh((-1, 1, 1, 1)))
    world = RoleWorld()
    assert world.size == 2

    def decided():
        world.still_waiting(deadline=60.0)
        world.still_waiting(deadline=60.0)
        return {"ordinal": 3}

    assert world.decide(decided, deadline=60.0) == {"ordinal": 3}
    got = world.leaves(leaves)
    want = leaves()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).reshape(-1).view(np.uint8).tobytes() == w.reshape(-1).view(np.uint8).tobytes()
    assert world.leaves(lambda: None) is None
    print("OK", peek_mesh().group("world").backend, flush=True)


if __name__ == "__main__":
    main()
