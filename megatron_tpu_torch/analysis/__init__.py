"""Communication analysis (counterpart of megatron_tpu/analysis/): the
collective vocabulary shared by the trace reader and the contracts
(taxonomy.py), and the golden comm contracts of the port's parallel
configurations (contracts.py, golden/*.json). Importing this package
imports neither torch nor the rest of the port."""
