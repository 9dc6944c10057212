from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    ArtifactRecovery,
    ElasticPlan,
    HeartbeatMonitor,
    PreemptionHandler,
    RecoveryEvent,
    StragglerDetector,
    plan_elastic_remesh,
)
