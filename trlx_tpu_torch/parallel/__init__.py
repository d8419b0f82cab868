"""The mesh and its groups, the host collectives and the sp groups
(:mod:`trlx_tpu_torch.parallel.mesh`), the dp / fsdp / tp collectives
(:mod:`trlx_tpu_torch.parallel.collectives`), the partition rules
(:mod:`trlx_tpu_torch.parallel.sharding`) and ring attention
(:mod:`trlx_tpu_torch.parallel.ring_attention`): the counterpart of
``trlx_tpu.parallel``."""

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
    node_count,
    set_mesh,
)
from trlx_tpu_torch.parallel.sharding import Placement, lm_partition_rules, match_rule, placement  # noqa: F401
