import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long end-to-end runs, deselected by -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU backend (the CUDA kernel has no interpreter); skips "
        "elsewhere.  On the card: python -m pytest -m gpu tests/",
    )
    if config.option.markexpr != "gpu":
        # every other run is on the CPU, on a virtual 8-device mesh, whatever
        # accelerator the machine has; set before any test imports JAX
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        ).strip()


@pytest.fixture(scope="session")
def community(tmp_path_factory):
    """A seeded 1,000-read mock community (db/community.py): the reads FASTQ,
    its templates FASTA, and the template count.  With the default seed the
    host pipeline recovers every template exactly."""
    from savont_tpu.db.community import write_community

    return write_community(tmp_path_factory.mktemp("community"), 1000)
