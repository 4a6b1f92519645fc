"""Multi-GPU parallelism on one host (counterpart of megatron_tpu/parallel):
process-group bring-up, the rank layout and its groups, per-parameter
sharding rules and the autograd collectives of tensor and sequence
parallelism."""
