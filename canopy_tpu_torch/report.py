"""Report serialization: JSON and Open-PSA-style XML.

The MEF ecosystem expects an XML results document (the reference points
its validator environment at a ``report.rng`` schema, ``env.h:37-40``).
This writer (``xml.etree`` from the standard library; the GPU machine
has no lxml) emits a SCRAM-flavored report: an ``<information>`` header
(software, time, analysis flags, per-phase timings), then one ``<results>``
section with ``<sum-of-products>`` per fault-tree analysis (products with
order/probability/literals), ``<importance>`` tables, ``<measure>``
blocks for uncertainty, ``<curve>`` for SIL sweeps, and
``<initiating-event>`` sequence tables.
"""

from __future__ import annotations

import xml.etree.ElementTree as etree

from . import __version__
from .engine.analysis import Report

__all__ = ["report_to_xml"]


def _sub(parent, tag, text=None, **attrs):
    el = etree.SubElement(parent, tag,
                          {k.replace("_", "-"): str(v)
                           for k, v in attrs.items() if v is not None})
    if text is not None:
        el.text = str(text)
    return el


def report_to_xml(report: Report) -> bytes:
    root = etree.Element("report")

    info = _sub(root, "information")
    software = _sub(info, "software", name="canopy-tpu-torch",
                    version=__version__)
    _sub(info, "model", name=report.model)
    calculated = _sub(info, "calculated-quantity")
    for key, value in report.settings.items():
        _sub(calculated, "setting", name=key, value=value)
    performance = _sub(info, "performance")
    for phase, seconds in report.timings.items():
        _sub(performance, "calculation-time", text=f"{seconds:.6f}",
             name=phase)

    results = _sub(root, "results")
    for ft in report.fault_trees:
        attrs = dict(name=ft.top_event, fault_tree=ft.fault_tree,
                     method=ft.method)
        if ft.alignment:
            attrs.update(alignment=ft.alignment, phase=ft.phase)
        analysis = _sub(results, "fault-tree-analysis", **attrs)
        if ft.probability is not None:
            _sub(analysis, "probability", value=ft.probability)
        if ft.mc_std_error is not None:
            _sub(analysis, "standard-error", value=ft.mc_std_error)
        if ft.products is not None:
            sop = _sub(analysis, "sum-of-products",
                       products=ft.n_products,
                       truncated=str(ft.products_truncated).lower())
            for order, prob, literals in ft.products:
                product = _sub(sop, "product", order=order,
                               probability=prob)
                for literal in literals:
                    if literal.startswith("not "):
                        notter = _sub(product, "not")
                        _sub(notter, "basic-event", name=literal[4:])
                    else:
                        _sub(product, "basic-event", name=literal)
        if ft.importance is not None:
            importance = _sub(analysis, "importance")
            for row in ft.importance:
                _sub(importance, "basic-event", name=row["event"],
                     MIF=row["MIF"], CIF=row["CIF"], DIF=row["DIF"],
                     RAW=row["RAW"], RRW=row["RRW"],
                     occurrence=row.get("occurrence"))
        if ft.uncertainty is not None:
            unc = ft.uncertainty
            measure = _sub(analysis, "measure", mean=unc["mean"],
                           standard_deviation=unc["std"],
                           error_factor=unc["error_factor"])
            ci = _sub(measure, "confidence-range", percentage="95",
                      lower_bound=unc["ci95"][0],
                      upper_bound=unc["ci95"][1])
            del ci
            quantiles = _sub(measure, "quantiles",
                             number=len(unc["quantiles"]))
            for i, q in enumerate(unc["quantiles"]):
                _sub(quantiles, "quantile", number=i + 1, value=q)
            histogram = _sub(measure, "histogram",
                             number=len(unc["histogram_density"]))
            edges = unc["histogram_edges"]
            for i, density in enumerate(unc["histogram_density"]):
                _sub(histogram, "bin", number=i + 1, value=density,
                     lower_bound=edges[i], upper_bound=edges[i + 1])
        if ft.sil is not None:
            sil = _sub(analysis, "safety-integrity-levels",
                       PFD_avg=ft.sil["pfd_avg"],
                       PFH_avg=ft.sil["pfh_avg"],
                       SIL=ft.sil["sil_level"])
            histogram = _sub(sil, "pfd-fractions")
            for band, fraction in ft.sil["pfd_fractions"].items():
                _sub(histogram, "fraction", name=band, value=fraction)
            if ft.time_curve is not None:
                curve = _sub(sil, "curve", X_title="time", Y_title="PFD")
                for t, value in ft.time_curve:
                    _sub(curve, "point", X=t, Y=value)

    if report.sequences:
        for seq in report.sequences:
            analysis = _sub(results, "initiating-event",
                            name=seq.initiating_event,
                            event_tree=seq.event_tree)
            element = _sub(analysis, "sequence", name=seq.sequence,
                           value=seq.probability)
            for functional_event, state in seq.states.items():
                _sub(element, "functional-event", name=functional_event,
                     state=state)
            if getattr(seq, "uncertainty", None):
                unc = seq.uncertainty
                _sub(element, "uncertainty", mean=unc["mean"],
                     standard_deviation=unc["std"],
                     error_factor=unc["error_factor"],
                     lower_bound=unc["ci95"][0],
                     upper_bound=unc["ci95"][1],
                     trials=unc["n_trials"],
                     method=unc.get("method"))

    etree.indent(root)
    return etree.tostring(root, xml_declaration=True,
                          encoding="UTF-8") + b"\n"
