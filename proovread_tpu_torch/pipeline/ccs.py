"""PacBio subread detection, from ``proovread_tpu/pipeline/ccs.py``: the
ZMW id parser the command line uses to choose between a mode and its
``-noccs`` variant (``bin/proovread:1512-1517``).

The subread consensus itself (``ccs_correct``, the ``ccs-1`` task) is not
ported yet; ``run_tasks`` refuses that task by name.
"""

from __future__ import annotations

import re
from typing import Optional

ZMW_RE = re.compile(r"^(m[^/]+/\d+)/(\d+_\d+)")


def zmw_of(read_id: str) -> Optional[str]:
    m = ZMW_RE.match(read_id)
    return m.group(1) if m else None


def is_subread_set(records) -> bool:
    """Mode auto-detection: all ids must parse as PacBio subreads, else the
    driver falls back to -noccs (bin/proovread:1512-1517)."""
    return bool(records) and all(zmw_of(r.id) is not None for r in records)
