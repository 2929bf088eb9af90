# repro_torch.part — the participation subsystem: who is up (availability traces),
# who reports (samplers), and the helpers that turn a participant set into
# the engine's mask slots.  Deadline-induced dropouts live in
# repro_torch.netsim.adapters; pass-through scheduling in repro_torch.core.scheduler.
from repro_torch.part.traces import (
    AlwaysOn,
    AvailabilityAware,
    AvailabilityTrace,
    BernoulliTrace,
    FullParticipation,
    GilbertElliottTrace,
    Sampler,
    UniformK,
    is_full_participation,
    participation_mask,
    schedule_participants,
    stack_masks,
)

__all__ = [
    "AvailabilityTrace",
    "AlwaysOn",
    "BernoulliTrace",
    "GilbertElliottTrace",
    "Sampler",
    "FullParticipation",
    "AvailabilityAware",
    "UniformK",
    "is_full_participation",
    "participation_mask",
    "schedule_participants",
    "stack_masks",
]
