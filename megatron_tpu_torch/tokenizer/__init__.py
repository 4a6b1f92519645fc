from megatron_tpu_torch.tokenizer.tokenizer import (  # noqa: F401
    NullTokenizer, build_tokenizer,
)
