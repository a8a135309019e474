import os
import sys

import pytest

# Tests see ONE CPU device (the 512-device flag belongs to dryrun.py only).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Fast-tier per-test time budget (seconds). ROADMAP's "<2 min fast tier"
# contract is machine-checked: any test NOT marked `slow` whose BODY
# (the `call` phase) takes longer than this FAILS, instead of quietly
# eroding the tier until the total blows the budget. Fixture setup is
# deliberately exempt — module-scoped fixtures are shared, and charging
# their one-time cost to whichever test runs first would fail it for
# work it amortizes across the module. Override with REPRO_FAST_BUDGET_S
# (0 disables — e.g. on a heavily-loaded or emulated machine).
FAST_BUDGET_S = float(os.environ.get("REPRO_FAST_BUDGET_S", "20"))


def pytest_configure(config):
    # Two test tiers (see README "Testing"):
    #   fast:  python -m pytest -m "not slow"   (CPU, well under 2 minutes)
    #   full:  python -m pytest                 (adds Pallas interpret-mode
    #          sweeps, model-zoo smoke tests, subprocess system tests)
    config.addinivalue_line(
        "markers",
        "slow: long-running Pallas/system tests, excluded from the fast "
        'tier (-m "not slow")',
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's hand-written kernels); "
        "skips with a reason where there is none",
    )


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    outcome = yield
    report = outcome.get_result()
    if (
        FAST_BUDGET_S > 0
        and report.when == "call"
        and report.passed
        and "slow" not in item.keywords
        and report.duration > FAST_BUDGET_S
    ):
        report.outcome = "failed"
        report.longrepr = (
            f"{item.nodeid} took {report.duration:.1f}s — over the "
            f"{FAST_BUDGET_S:g}s fast-tier per-test budget. Mark it "
            "`slow` (nightly tier) or speed it up; the <2 min fast-tier "
            "contract in ROADMAP.md is enforced here. Override with "
            "REPRO_FAST_BUDGET_S=<seconds> (0 disables)."
        )
