"""idle_in_launch.offline: the share of the traced window in which the device was
idle while the host was in ``creator.dispatch`` outside its uploads: keypoints
(``creator.keypoints``), the Pi3 forward's launches (``pi3.encoder``,
``pi3.decoder``, ``pi3.heads``), ``step.post`` and MoGe-2's
(``moge.forward``).
The split is ``portbench/spans.py``'s: the program's own spans laid onto the
trace by their clock anchor, each idle microsecond charged to the innermost
span of the creator's thread. The six ``idle_in_*`` / ``idle_unattributed``
shares sum to ``idle_share.offline``. None where the program recorded no
span."""

from portbench.spans import read_share

NAME = "idle_in_launch.offline"
UNIT = "%"
LAYER = "chunk step and models"


def read(run):
    return read_share(run, "launch")
