"""Training paligemma-3b, hubert-xlarge and deepseek-v3-671b against the
reference, on the CPU, with ``test_torch_train_archs.py``'s helpers (its
docstring states what is held and the tolerances): ``loss_fn`` and every
leaf's gradient in fp32 (paligemma and hubert on random frontend
embeddings; deepseek-v3's aux and MTP terms among the metrics), and three
EF-HC train steps at m=4, pods=2, in fp32 (paligemma on the neighbor
schedule, the others dense).  The reference runs inside
``jax.threefry_partitionable(False)``.
"""
import pytest

pytest.importorskip("torch")

from test_torch_train_archs import check_loss_and_grads, check_train_steps  # noqa: E402

ARCHS = ("paligemma-3b", "hubert-xlarge", "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch,mix", [("paligemma-3b", "neighbor"), ("hubert-xlarge", "dense"),
                                      ("deepseek-v3-671b", "dense")])
def test_train_steps_match_reference(arch, mix):
    check_train_steps(arch, "float32", mix)
