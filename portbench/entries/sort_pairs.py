"""Entry ``sort_pairs``: the ``sort`` entry with values."""

from portbench.entries.sort import (  # noqa: F401
    LIMITS, call, check, controls, job_bytes, pool_input)
