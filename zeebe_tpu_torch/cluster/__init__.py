from zeebe_tpu_torch.cluster.gossip import Gossip, GossipConfig, Member, MemberStatus
from zeebe_tpu_torch.cluster.raft import Raft, RaftConfig, RaftState

__all__ = [
    "Gossip",
    "GossipConfig",
    "Member",
    "MemberStatus",
    "Raft",
    "RaftConfig",
    "RaftState",
]
