"""One train step of the port (``make_train_step``) against the JAX package's
for xLSTM (mLSTM and sLSTM): the loss, the grad norm, every gradient leaf,
AdamW's moments and the updated params, from the reference's params and
state (converted through ``convert``) on one SyntheticTokens batch, in
float32 and in bf16. The tolerances and the float32 ``grad_cast_bf16`` rule
are in tests/_train_reference.py; the step files are split by family so
that parallel workers run them side by side.
"""
import pytest
import torch

from _train_reference import check_step

torch.set_num_threads(1)

ARCHS = ["xlstm-350m"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, dtype):
    check_step(arch, dtype)
