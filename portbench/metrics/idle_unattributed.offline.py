"""idle_unattributed.offline: the share of the traced window in which the device was
idle while the host was in no creator stage: between stages, before the first and
after the last in the traced slice.
The split is ``portbench/spans.py``'s: the program's own spans laid onto the
trace by their clock anchor, each idle microsecond charged to the innermost
span of the creator's thread. The six ``idle_in_*`` / ``idle_unattributed``
shares sum to ``idle_share.offline``. None where the program recorded no
span."""

from portbench.spans import read_share

NAME = "idle_unattributed.offline"
UNIT = "%"
LAYER = "device"


def read(run):
    return read_share(run, "unattributed")
