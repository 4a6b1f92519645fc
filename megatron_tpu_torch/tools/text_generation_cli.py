"""Interactive client of the port's generation server (counterpart of
tools/text_generation_cli.py, the reference's tools/text_generation_cli.py):
reads prompts from stdin, PUTs each to the server's /api and prints the
text it answers.

    python -m megatron_tpu_torch.tools.text_generation_cli localhost:5000
    printf 'Hello\\n' | python -m megatron_tpu_torch.tools.text_generation_cli \\
        localhost:5000 --tokens_to_generate 16

It imports neither torch nor the rest of the port: only urllib.
"""

import argparse
import json
import sys
import urllib.request


def generate(url: str, prompt: str, tokens_to_generate: int = 64,
             timeout: float = 600.0) -> str:
    """The server's text for one prompt (PUT /api)."""
    body = json.dumps({"prompts": [prompt],
                       "tokens_to_generate": tokens_to_generate}).encode()
    req = urllib.request.Request(url, data=body, method="PUT",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())["text"][0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("address", help="host:port of the server")
    p.add_argument("--tokens_to_generate", type=int, default=64)
    args = p.parse_args(argv)
    url = f"http://{args.address}/api"
    while True:
        try:
            prompt = input("Enter prompt: ")
        except EOFError:
            break
        if not prompt:
            continue
        print("Megatron-TPU:", generate(url, prompt, args.tokens_to_generate),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
