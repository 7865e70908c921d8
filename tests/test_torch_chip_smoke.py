"""chip_smoke.py's kernel checks at tiny latents on the CPU, where every
wrapper runs its plain version: each case must pass its own check, and each
planted fault (zeroed attention, half the keys; for the backward kernels
delta dropped, the softmax Jacobian's row-sum term dropped, the g * pdf(g)
term dropped) must fail it. This holds the checks' power to see a wrong
kernel, not the kernels themselves (those run only on the card)."""
from __future__ import annotations

import pytest
import torch

import chip_smoke as CS
import mudg_tpu_torch.kernels as K
from mudg_tpu_torch.nn import attention as nn_att


@pytest.mark.parametrize("config", ["mdm512", "mdm1024"])
def test_chip_smoke_checks_see_planted_faults(config):
    seen = set()
    # cases are consumed one by one: their closures bind the current inputs
    for case in CS.kernel_cases(torch, K, nn_att, (config,), dev="cpu",
                                latent={config: (8, 8)}):
        chk = CS.compare(torch, case)
        assert chk.err == 0.0 and chk.scale > 0.0, (case.label, chk)
        assert chk.lse_err in (None, 0.0), (case.label, chk)
        for name, err in chk.faults.items():
            assert err > CS.TOL * chk.scale, (case.label, name, err, chk.scale)
        assert chk.ok
        seen.add(case.name)
        adds_residual = (case.name in ("spatial_attn", "temporal_attn")
                         or case.label.startswith("block"))
        assert (case.base is not None) == adds_residual, case.label
    forward = {n for n in K.KERNELS if not n.endswith("_bwd")}
    assert seen == forward - ({"flash_attention"} if config == "mdm512" else set())


def test_chip_smoke_grad_checks_see_planted_faults():
    seen = set()
    for case in CS.grad_cases(torch, K, nn_att, dev="cpu",
                              latent={"mdm512": (8, 8), "mdm1024": (8, 16)}):
        chk = CS.compare(torch, case)
        assert chk.err == 0.0 and chk.ok, (case.label, chk)
        bound = CS.BWD_TOL if case.grads else CS.TOL * chk.scale
        assert chk.faults and all(e > bound for e in chk.faults.values()), (case.label,
                                                                            chk.faults)
        seen.add(case.name)
    # kernel 5's forward at each training length, before kernel 6 there
    assert seen == {n for n in K.KERNELS if n.endswith("_bwd")} | {"flash_attention"}
