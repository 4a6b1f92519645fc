"""Finetuning tasks over the BERT encoder (counterpart of the repo's
tasks/): GLUE's MNLI and QQP (classification) and RACE (multiple
choice), run by tasks/main."""
