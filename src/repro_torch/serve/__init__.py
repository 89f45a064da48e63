from repro_torch.serve.cold_service import AdmissionPolicy, ColdService, ContributorClient
from repro_torch.serve.probes import MultitaskEvals, ProbeReport, ProbeSuite, RegressionGate

__all__ = [
    "AdmissionPolicy", "ColdService", "ContributorClient", "MultitaskEvals", "ProbeReport",
    "ProbeSuite", "RegressionGate",
]
