"""``Model.loss`` and its gradients at bfloat16 against the reference's, for
the last five of the ten reduced configurations; the policy and the
routing are ``test_torch_bf16_train_models.py``'s, which holds the first
five."""

import pytest

from test_torch_bf16_train_models import ALL, check_loss_and_gradients_at_bf16


@pytest.mark.parametrize("arch", ALL[5:])
def test_loss_and_gradients_at_bf16_match_reference(arch, monkeypatch):
    check_loss_and_gradients_at_bf16(arch, monkeypatch)
