"""Problem I/O: XML problems, legacy text dumps, and SpMM pair-plan files
(numpy and ``xml.etree``, as in the JAX package's ``tfqmrgpu_tpu/io/``)."""

from .planfile import PlanFile, read_plan_file
from .legacy import LegacyProblem, read_legacy, write_legacy
from .xmlio import XmlProblem, read_xml, write_xml

__all__ = ["PlanFile", "read_plan_file", "LegacyProblem", "read_legacy",
           "write_legacy", "XmlProblem", "read_xml", "write_xml"]
