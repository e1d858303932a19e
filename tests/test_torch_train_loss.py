"""The port's training loss held against the live reference on the CPU.

For each of the six families, at its ``reduced_config`` and 2 layers:
``model_loss`` and the gradient of every parameter leaf (``torch.autograd``
against ``jax.value_and_grad`` of the reference's ``model_loss``), with a
MoE's aux in the loss, a VLM's patch embeddings and an enc-dec model's
frames. Weights come from the reference's ``model_init`` with biases and
norm scales perturbed and Mamba2's dt_bias drawn as Mamba2 initialises it
(at the reference's zero dt_bias fp32 Mamba2 is ill-conditioned, ROADMAP
C); 2 sequences of 16 tokens, so RoPE positions stay below ~100 (C9).
Tolerance: every float within 1e-5 of the reference relative to its leaf's
scale (``_torch_parity``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
from _torch_parity import (
    TRAIN_ARCHS, assert_close, assert_grads_close, jax_batch, port_value_and_grad, torch_batch,
    train_case,
)

from repro.models import api as japi
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import api as tapi


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    jcfg, tcfg, jp, batch = train_case(arch)
    jp = jax.tree.map(jnp.asarray, jp)
    (want, want_aux), want_g = jax.value_and_grad(
        lambda p: japi.model_loss(p, jcfg, jax_batch(batch)), has_aux=True)(jp)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    tb = torch_batch(batch)
    got, got_g = port_value_and_grad(lambda p: tapi.model_loss(p, tcfg, tb)[0], tp)
    assert_close(got, want)
    assert_close(tapi.model_loss(tp, tcfg, tb)[1], want_aux)
    assert_grads_close(got_g, want_g)
    if tcfg.arch_type == "moe":
        assert float(want_aux) > 0.0  # the aux is in the loss
