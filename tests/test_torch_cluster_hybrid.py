"""Cross-replica migration of the hybrid payload (reduced hymba-1.5b:
attention KV and SSM state together, 128 meta tokens reduced to 8) on port
engines, ring path and paged plane: the same checks as
``test_torch_cluster_multiarch.py`` — the fan-out crosses replicas as
migrated hits that skip prefill, and the port's fleet decodes exactly the
JAX fleet's tokens (report and trace digest too) and a cold port
engine's."""
import pytest

from test_torch_cluster_multiarch import check_migrated_hit, setup_for
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def hymba():
    return setup_for("hymba-1.5b")


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_migrated_hit_decodes_identically_hybrid(hymba, paged):
    check_migrated_hit(hymba, paged)
