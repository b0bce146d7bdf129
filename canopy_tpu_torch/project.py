"""Project files: one XML document naming inputs + analysis options.

The reference environment reserves a ``project.rng`` schema slot
(``env.h:27-31``) for SCRAM-style project/config documents; SURVEY.md §5
prescribes a config system "parseable from CLI and from MEF project
files". Format::

    <canopy-project>
      <input-files>
        <file>models/plant.xml</file>
        <file>models/data*.xml</file>
      </input-files>
      <options>
        <algorithm value="bdd"/>
        <approximation value="rare-event"/>
        <analysis probability="true" importance="true" ccf="true"/>
        <limits limit-order="10" cut-off="1e-10" mission-time="8760"
                num-trials="10000" seed="7" time-step="0"/>
      </options>
      <output file="report.xml"/>
    </canopy-project>

Relative input paths resolve against the project file's directory.
"""

from __future__ import annotations

import dataclasses
import os

from .errors import ValidityError
from .io.xml import Document
from .settings import Settings

__all__ = ["Project", "load_project"]


@dataclasses.dataclass
class Project:
    input_files: list[str]
    settings: Settings
    output: str | None = None


def load_project(path: str, validate: bool = True) -> Project:
    """Parse and (by default) validate a project file against the
    bundled ``schemas/project.rng`` (checked by hand: ``io/xml.Validator``)."""
    if validate:
        from .io.xml import Validator
        from .schemas import project_schema_path
        document = Document(path,
                            validator=Validator(project_schema_path()))
    else:
        document = Document(path)
    root = document.root
    if root.name != "canopy-project":
        raise ValidityError(
            f"Invalid project root element '{root.name}' "
            "(expected 'canopy-project').",
            filename=root.filename, line=root.line)
    base_dir = os.path.dirname(os.path.abspath(path))

    files_el = root.child("input-files")
    if files_el is None:
        raise ValidityError("Project file has no <input-files>.",
                            filename=root.filename, line=root.line)
    input_files = []
    for file_el in files_el.children("file"):
        name = file_el.text()
        if not name:
            raise ValidityError("Empty <file> entry.",
                                filename=file_el.filename,
                                line=file_el.line)
        input_files.append(name if os.path.isabs(name)
                           else os.path.join(base_dir, name))
    if not input_files:
        raise ValidityError("Project file lists no input files.",
                            filename=root.filename, line=root.line)

    settings = Settings()
    options = root.child("options")
    if options is not None:
        algorithm = options.child("algorithm")
        if algorithm is not None:
            settings.algorithm(algorithm.attribute("value"))
        approximation = options.child("approximation")
        if approximation is not None:
            settings.approximation(approximation.attribute("value"))
        analysis = options.child("analysis")
        if analysis is not None:
            for attr, setter in [
                    ("probability", settings.probability_analysis),
                    ("importance", settings.importance_analysis),
                    ("uncertainty", settings.uncertainty_analysis),
                    ("ccf", settings.ccf_analysis),
                    ("sil", settings.safety_integrity_levels),
                    ("prime-implicants", settings.prime_implicants),
                    ("skip-products", settings.skip_products)]:
                value = analysis.attribute(attr, bool)
                if value is not None:
                    setter(value)
        limits = options.child("limits")
        if limits is not None:
            for attr, setter, type_ in [
                    ("limit-order", settings.limit_order, int),
                    ("cut-off", settings.cut_off, float),
                    ("num-trials", settings.num_trials, int),
                    ("batch-size", settings.batch_size, int),
                    ("sample-size", settings.sample_size, int),
                    ("num-quantiles", settings.num_quantiles, int),
                    ("num-bins", settings.num_bins, int),
                    ("seed", settings.seed, int),
                    ("mission-time", settings.mission_time, float),
                    ("time-step", settings.time_step, float)]:
                value = limits.attribute(attr, type_)
                if value is not None:
                    setter(value)

    output_el = root.child("output")
    output = None
    if output_el is not None:
        output = output_el.attribute("file")
        if output and not os.path.isabs(output):
            output = os.path.join(base_dir, output)
    return Project(input_files=input_files, settings=settings,
                   output=output)
