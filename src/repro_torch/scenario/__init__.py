"""repro_torch.scenario — timing laws, their registry, and the parts of the
Scenario spec the main path uses (port of ``repro.scenario``)."""
from .laws import TimingLaw, get_law, law_names
from .registry import TIMING_LAWS, timing_law
from .spec import (PAPER_CLUSTERS_TABLE1, ClassSpec, ClusterSpec,
                   LearningSpec, NetworkSpec, expand_clusters)
