"""Row 15j at npop 8: every body of scripts/microbench_glue.py through the
script's own `_loop_kernel` in interpret mode against
parallel_ray_tracer_tpu_torch/microbench/glue.py's plain version at the
script's packet of 1,024 rays, e equal at K = 1, 3 and 16, acc 0; and the
bodies that share a plain version agree in the script. The fixtures and
checks are tests/test_torch_microbench_glue.py's (npop 4 there); each
body's interpret-mode compile takes 1-3 s here, so the two npop run as two
files, on two workers.
"""

import pytest
import torch

from parallel_ray_tracer_tpu_torch.microbench import glue
from test_torch_microbench_glue import check_body, check_shared_semantics, script, tab  # noqa: F401

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools


@pytest.mark.parametrize("npop", [8])
@pytest.mark.parametrize("body", list(glue.BODIES))
def test_body_matches_script(script, tab, body, npop):  # noqa: F811
    check_body(script, tab, body, npop)


def test_shared_semantics(script):  # noqa: F811
    check_shared_semantics(script, 8)
