"""Replicated serving: a health-checked fleet of RetrievalServers."""

from repro_torch.serving.fleet import (AutoCompactPolicy, FaultEvent, FaultPlan,
                                       FaultState, FaultableIndex, HealthPolicy,
                                       NoHealthyReplica, Replica, ReplicaCrash,
                                       ReplicaSet, Router, Shed, corrupt_artifact)

__all__ = ["AutoCompactPolicy", "FaultEvent", "FaultPlan", "FaultState",
           "FaultableIndex", "HealthPolicy", "NoHealthyReplica", "Replica",
           "ReplicaCrash", "ReplicaSet", "Router", "Shed",
           "corrupt_artifact"]
