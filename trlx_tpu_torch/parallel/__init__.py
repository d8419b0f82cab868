"""Sequence parallelism: the mesh, the sp groups and the host collectives
(:mod:`trlx_tpu_torch.parallel.mesh`), and ring attention
(:mod:`trlx_tpu_torch.parallel.ring_attention`). The counterpart of
``trlx_tpu.parallel``, whose dp / fsdp / tp partition rules are not ported
(ROADMAP §A11)."""

from trlx_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DP,
    AXIS_FSDP,
    AXIS_SP,
    AXIS_TP,
    DATA_AXES,
    MESH_AXES,
    DistSpGroup,
    LocalSpGroup,
    Mesh,
    barrier,
    get_mesh,
    init_distributed,
    is_main_process,
    make_mesh,
    set_mesh,
)
