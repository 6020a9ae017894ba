"""Toy vocabularies for the port's CPU tests: ``build_toy_tokenizer``'s
vocab and merges written as ``vocab.json`` + ``merges.txt`` (the GPT-2
artifact format), GPT-2-flavoured (``<|endoftext|>``) or OPT-flavoured
(``</s>`` as well), so both packages load the same files."""
import json
import os

WORDS = ["image", "a", "cat", "dog", "picture", "of", "red", "the", "on",
         "sat", "mat", "<", ">", "photo", "is", "here", "tokenization",
         "it", "you", "re", "ve", "ll"]


def write_toy_vocab(path, family: str = "gpt2", words=WORDS) -> str:
    """Write the files into the directory ``path`` -> ``path``."""
    from flamingo_mini_tpu_torch.tokenizer import build_toy_tokenizer
    tok = build_toy_tokenizer(list(words))
    vocab = dict(tok.encoder)
    if family == "opt":
        vocab["</s>"] = len(vocab)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for (a, b), _ in sorted(tok.bpe_ranks.items(), key=lambda kv: kv[1]):
            f.write(f"{a} {b}\n")
    return str(path)
