"""The MXU leaf at leaf size 4 in the port against the JAX package (the rest
of leaf size 4 is in tests/test_torch_leaf4.py, whose scene, tables and
checks this file reuses; the frames in tests/test_torch_leaf4_frame.py):
the wrappers at L = 4 against JAX's kernels in interpret mode on one packet
of 1,024 rays, with bf16 pair rows at width 8 and with the MXU leaf (4L =
16 C rows a group) at widths 4 and 8. Bounds as tests/test_torch_leaf4.py.
"""

import pytest
import torch

from test_torch_leaf4 import check_wrappers, scene  # noqa: F401

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

# (width, bf16 boxes, MXU leaf)
CASES = {"w8_bf16": (8, True, False), "w4_mxu": (4, False, True), "w8_mxu": (8, False, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_wrappers_match_jax(scene, case):  # noqa: F811
    check_wrappers(scene, CASES[case])
