"""The reference's scenario suite through both packages on the CPU, second
half (test_torch_scenarios.py says what each case holds the port to): repeats
longer than the reads in the corrected-read regime of tests/test_scale.py
(interior paths, inverted copies, a tandem array), whose walks run 48 and 96
steps, so score_sum takes XLA's windowed reduce order and consensus rule 5
picks representatives by it; and het bubbles with polish on."""

import pytest
from test_torch_scenarios import adjacent, assert_port_matches_reference, write_sim

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.sim import SimConfig

CORRECTED_READS = dict(
    read_len_mean=2_500, read_len_sd=400, read_min_len=800, coverage=24.0,
    error_rate=0.005, ins_rate=0.0025, del_rate=0.0025, end_jitter=10,
    min_sim_overlap=300, cross_copy_overlaps=True, copy_divergence=0.04)
SIMS = {
    "interior": SimConfig(genome_len=300_000, repeat_len=8_000, n_repeat_copies=4, seed=5,
                          **CORRECTED_READS),
    "inverted": SimConfig(genome_len=300_000, repeat_len=8_000, n_repeat_copies=4,
                          inverted_copies=(1, 3), seed=21, **CORRECTED_READS),
    "tandem": SimConfig(genome_len=260_000, repeat_len=4_000, n_repeat_copies=6,
                        tandem_pairs=2, seed=22, **{**CORRECTED_READS, "read_len_sd": 300}),
}


def corrected_cfg(max_steps: int) -> ScaffoldConfig:
    return ScaffoldConfig(mc_walks_per_end=400, max_steps=max_steps, min_identity=0.97)


@pytest.fixture(scope="module")
def tandem_data(tmp_path_factory):
    return write_sim(tmp_path_factory, "tandem", SIMS["tandem"])


@pytest.mark.parametrize("name", ["interior", "inverted"])
def test_repeats_longer_than_reads_at_48_steps(tmp_path_factory, tmp_path, name):
    d = write_sim(tmp_path_factory, name, SIMS[name])
    got = assert_port_matches_reference(d, corrected_cfg(48), tmp_path, adjacent(4))
    assert (got.walks.steps > 24).any()   # sums that span both 24-step windows


@pytest.mark.parametrize("max_steps", [48, 96])
def test_tandem_array(tandem_data, tmp_path, max_steps):
    got = assert_port_matches_reference(tandem_data, corrected_cfg(max_steps), tmp_path,
                                        adjacent(4))
    assert (got.walks.steps > 32).any()


def test_het_bubbles_with_polish(tmp_path_factory, tmp_path):
    d = write_sim(tmp_path_factory, "het", SimConfig(
        genome_len=150_000, repeat_len=3_000, n_repeat_copies=3, read_len_mean=5_000,
        read_len_sd=800, read_min_len=800, coverage=16.0, error_rate=0.02, het_rate=0.002,
        cross_copy_overlaps=True, copy_divergence=0.02, seed=23))
    got = assert_port_matches_reference(
        d, ScaffoldConfig(mc_walks_per_end=200, max_steps=32, polish=True), tmp_path,
        adjacent(3))
    assert "polish" in got.metrics.values and len(got.scaffolds) == 1
