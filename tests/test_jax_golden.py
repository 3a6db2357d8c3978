"""The stored JAX references of the port's parity tests
(``tests/golden/jax/``, ``tests/jax_golden.py``) against this tree: each
was computed from the ``semantic_slam_tpu/`` sources here and for its
family's spec as its test module states it, and passed the drift check.
Where not, the failure names ``tests/golden/regen_jax.py``'s command. (Each
family's ``check_live`` test, in its own module, recomputes one stored call
against the package.)"""

import os

import pytest

import jax_golden


@pytest.mark.parametrize("name", sorted(jax_golden.FAMILY_MODULES))
def test_stored_reference_matches_tree(name):
    fam = jax_golden.family(name)
    meta = fam.meta()
    if meta["source"] != jax_golden.source_hash():
        fam.fail("was computed from other semantic_slam_tpu/ sources")
    if meta["spec"] != fam.spec_digest():
        fam.fail("was computed for another spec (its tolerance)")
    assert meta["drift"]["worst"] <= jax_golden.DRIFT_BOUND


def test_every_stored_reference_has_a_family():
    stored = sorted(f[:-4] for f in os.listdir(jax_golden.GOLDEN_DIR) if f.endswith(".npz"))
    assert stored == sorted(jax_golden.FAMILY_MODULES)
