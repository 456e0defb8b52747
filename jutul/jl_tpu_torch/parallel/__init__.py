"""parallel — graph partitioning (host numpy), shard groups and their
collectives (``comm``), the slab and general-partition SPMD engines with
their distributed CPR and adjoints, and dd submodel extraction."""
