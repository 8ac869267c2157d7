"""The port's architecture registry equals the reference's, field by field."""
import dataclasses

import pytest

from repro import configs as RC
from repro_torch import configs as TC


@pytest.mark.parametrize("arch", sorted(RC.REGISTRY))
def test_config_and_smoke_match_reference(arch):
    ref, port = RC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(TC.smoke(port)) == dataclasses.asdict(
        RC.smoke(ref))
    assert port.padded_vocab == ref.padded_vocab
    assert TC.dtype_name(port.dtype) == ref.dtype.name
    assert TC.dtype_name(port.pdtype) == ref.pdtype.name


def test_registry_shapes_and_errors_match_reference():
    assert TC.list_archs() == RC.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")
