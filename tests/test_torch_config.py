"""The port's SAConfig copy against ``repro.config.SAConfig``."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.config import SAConfig as RefConfig
from repro_torch.config import SAConfig, sa_config_from_reference

CFGS = [  # tests/test_kernels.py CFGS
    dict(vocab_size=4, packing="base"),
    dict(vocab_size=4, packing="bits"),
    dict(vocab_size=4, chars_per_word=3, key_words=2, packing="base"),
    dict(vocab_size=255, packing="bits"),
]


def test_fields_and_defaults_match():
    ref = [(f.name, f.default) for f in dataclasses.fields(RefConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(SAConfig)]
    assert port == ref
    assert dataclasses.asdict(SAConfig()) == dataclasses.asdict(RefConfig())


@pytest.mark.parametrize("kw", CFGS, ids=str)
def test_derived_values_match(kw):
    ref, port = RefConfig(**kw), SAConfig(**kw)
    assert port.resolved_chars_per_word() == ref.resolved_chars_per_word()
    assert port.prefix_len == ref.prefix_len


@pytest.mark.parametrize("kw", [*CFGS, dict(use_pallas=True, adaptive=False,
                                             server_pack=False,
                                             fetch_fraction=0.25)], ids=str)
def test_config_from_reference_round_trips(kw):
    ref = RefConfig(**kw)
    port = sa_config_from_reference(dataclasses.asdict(ref))
    assert isinstance(port, SAConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_config_from_reference_rejects_other_fields():
    d = dataclasses.asdict(RefConfig())
    with pytest.raises(ValueError, match="unknown"):
        sa_config_from_reference({**d, "extra": 1})
    d.pop("mode")
    with pytest.raises(ValueError, match="missing"):
        sa_config_from_reference(d)


def test_superblock_config_fields_and_defaults_match():
    from repro.config import SuperblockConfig as RefSB
    from repro_torch.config import SuperblockConfig

    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(RefSB)]
    port = [(f.name, f.type, f.default) for f in dataclasses.fields(SuperblockConfig)]
    assert port == ref
    assert dataclasses.asdict(SuperblockConfig()) == dataclasses.asdict(RefSB())


def test_superblock_config_from_reference_round_trips():
    from repro.config import SuperblockConfig as RefSB
    from repro_torch.config import SuperblockConfig, superblock_config_from_reference

    ref = RefSB(num_superblocks=3, emit_lcp=True, request_capacity=7,
                spill_dir="/x", store_backoff_s=0.5)
    port = superblock_config_from_reference(dataclasses.asdict(ref))
    assert isinstance(port, SuperblockConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    with pytest.raises(ValueError, match="unknown"):
        superblock_config_from_reference({**dataclasses.asdict(ref), "extra": 1})
