"""The reference of the v4/v5 generation, direct regression: the network of
``net.py`` (``StereoPoseNet``, the published ``StereoPoseNet_with_depth``)
and the whole estimate of ``estimate.py``. A configuration without a
``"reference"`` key takes this one."""

from portbench.reference import estimate as RE
from portbench.reference import net as RN


def network(cfg):
    return RN.StereoPoseNet(cfg["backend"], cfg["backbone_stride"], cfg["volume_scale"],
                            cfg["warp_mode"])


estimate = RE.estimate
