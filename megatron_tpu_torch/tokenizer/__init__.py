from megatron_tpu_torch.tokenizer.tokenizer import (  # noqa: F401
    AbstractTokenizer, GPT2BPETokenizer, HFTokenizer, NullTokenizer,
    SentencePieceTokenizer, build_tokenizer, pad_vocab_size,
)
