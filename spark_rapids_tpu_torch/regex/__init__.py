"""Device regex — the counterpart of spark_rapids_tpu/regex/: a Java-regex
subset parses to a Glushkov position automaton (at most 32 positions, one
state mask per row; parser.py and program.py are copies of the JAX
package's, pure Python and numpy), and matching advances every row one
byte per step (kernel.py). spans.py finds match extents for
regexp_replace and regexp_extract.

Unsupported constructs (backreferences, lookaround, lazy quantifiers,
unbounded counted repeats, Unicode classes) raise RegexUnsupported at
plan time, so the planner tags the expression off, as the reference's
transpiler does.
"""

from .parser import RegexUnsupported, parse_regex  # noqa: F401
from .program import RegexProgram, compile_regex, like_to_program  # noqa: F401
from .kernel import regex_find  # noqa: F401
