"""The training path: schedule, optimizer, train step, microbatch
accounting and the pretrain loop (counterpart of megatron_tpu/training/)."""
