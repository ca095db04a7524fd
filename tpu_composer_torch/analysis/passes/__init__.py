"""tpuc-lint pass registry: one pass per invariant the repo paid for.
(Port of ``tpu_composer/analysis/passes/__init__.py``.)

Adding a pass: implement it in a module here, append an instance to
``PASSES``, add a known-bad + fixed fixture pair under
``tests/analysis_fixtures/<pass-id>/`` and a proof in
tests/test_torch_analysis.py that the pass fails on the bad form and
accepts the fixed form. A pass without a failing fixture is not proven to
check anything.
"""

from tpu_composer_torch.analysis.passes.docs_drift import (
    EnvKnobDriftPass,
    MetricDocDriftPass,
)
from tpu_composer_torch.analysis.passes.excepts import BareExceptPass
from tpu_composer_torch.analysis.passes.fabric_paths import (
    FabricMutationPathPass,
)
from tpu_composer_torch.analysis.passes.intent_protocol import (
    IntentProtocolPass,
)
from tpu_composer_torch.analysis.passes.threads import NamedThreadPass
from tpu_composer_torch.analysis.passes.wallclock import WallClockPass

PASSES = [
    FabricMutationPathPass(),
    IntentProtocolPass(),
    WallClockPass(),
    BareExceptPass(),
    NamedThreadPass(),
    EnvKnobDriftPass(),
    MetricDocDriftPass(),
]
