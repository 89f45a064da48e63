from repro_torch.serve.base_follower import BaseFollower, BaseVersion
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService, ContributorClient
from repro_torch.serve.hot_swap import ServedGeneration, ServingWorker
from repro_torch.serve.probes import MultitaskEvals, ProbeReport, ProbeSuite, RegressionGate
from repro_torch.serve.router import EndpointDied, LocalEndpoint, RoutedResult, Router
from repro_torch.serve.scheduler import BatchScheduler, RequestRejected, SchedResult, batch_bucket

__all__ = [
    "AdmissionPolicy", "BaseFollower", "BaseVersion", "BatchScheduler", "ColdService",
    "ContributorClient", "EndpointDied", "LocalEndpoint", "MultitaskEvals", "ProbeReport",
    "ProbeSuite", "RegressionGate", "RequestRejected", "RoutedResult", "Router", "SchedResult",
    "ServedGeneration", "ServingWorker", "batch_bucket",
]

