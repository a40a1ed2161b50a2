"""The port's `repro_torch.hash` exports what `repro.hash` exports."""
import repro.hash as J
import repro_torch.hash as T

# The recorded difference: the port has no plan object (a Hasher's device
# is its plan), so `HashPlan` and `default_plan` have no counterpart.
NOT_EXPORTED = {"HashPlan", "default_plan"}


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")
            and n not in ("annotations",)}


def test_hash_exports_match_reference():
    missing = _public(J) - _public(T)
    assert missing == NOT_EXPORTED, sorted(missing)
    for name in sorted(_public(J) - NOT_EXPORTED):
        assert hasattr(T, name), name


def test_port_exports_nothing_the_reference_lacks():
    assert _public(T) - _public(J) == set(), sorted(_public(T) - _public(J))
