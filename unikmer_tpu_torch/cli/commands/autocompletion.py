"""autocompletion: generate shell completion scripts (port of
unikmer_tpu/cli/commands/autocompletion.py) for ``unikmer-tpu-torch``.

Reference: unikmer/cmd/autocomplete.go (bash/zsh/fish/powershell).
bash, zsh and fish get a completer of the port's registered commands
(plus the aliases stats and uniqs); powershell exits as unsupported, as
in the JAX command.
"""

from __future__ import annotations

import os

from ...utils.log import die, log
from ._common import new_command
from . import COMMANDS


def register(subparsers):
    p = new_command(subparsers, "autocompletion", "Generate shell autocompletion script")
    p.add_argument("--file", default="~/.bash_completion.d/unikmer-tpu-torch.sh",
                   help="autocompletion file")
    p.add_argument("--type", default="bash",
                   choices=["bash", "zsh", "fish", "powershell"],
                   help="autocompletion type")
    p.set_defaults(func=run)


def _bash_script() -> str:
    cmds = " ".join(COMMANDS + ["stats", "uniqs"])
    return f"""# bash completion for unikmer-tpu-torch
_unikmer_tpu_torch_completions() {{
    local cur="${{COMP_WORDS[COMP_CWORD]}}"
    if [ "$COMP_CWORD" -eq 1 ]; then
        COMPREPLY=( $(compgen -W "{cmds}" -- "$cur") )
    else
        COMPREPLY=( $(compgen -f -- "$cur") )
    fi
}}
complete -F _unikmer_tpu_torch_completions unikmer-tpu-torch
"""


def _zsh_script() -> str:
    cmds = " ".join(COMMANDS + ["stats", "uniqs"])
    return f"""#compdef unikmer-tpu-torch
_arguments "1: :({cmds})" "*:file:_files"
"""


def _fish_script() -> str:
    lines = [
        f"complete -c unikmer-tpu-torch -n '__fish_use_subcommand' -a {c}"
        for c in COMMANDS + ["stats", "uniqs"]
    ]
    return "\n".join(lines) + "\n"


def run(args) -> int:
    if args.type == "bash":
        script = _bash_script()
    elif args.type == "zsh":
        script = _zsh_script()
    elif args.type == "fish":
        script = _fish_script()
    else:
        die(f"autocompletion type not supported: {args.type}")
    path = os.path.expanduser(args.file)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(script)
    log.warning(f"{args.type} completion file for unikmer-tpu-torch saved to {path}")
    return 0
