"""MEF text of the event-tree scale model (``tests/test_event_tree_scale.py``).

Six binary functional-event forks (2^6 = 64 sequences), each system an OR
of its own two basic events and one basic event ``common`` shared by all
of them, so bottom-up propagation alone is approximate and the BDD path
carries the exact values.  Sequence ``seq{bits}`` has bit ``k`` set where
system ``k`` failed.

Two options extend the JAX package's generator, both off by default (the
text is then that generator's):

* ``deviates``: ``common`` and every ``a{k}`` become lognormal deviates of
  the same means (error factor 3 at level 0.95), so sequence uncertainty
  has something to sample;
* ``house_flip``: every system also ORs the gate ``maint-line`` (house
  event ``maint`` AND basic event ``m``), and the failure path of ``FE0``
  sets ``maint`` true, so the sequences carry two house vectors.

:func:`every_deviate_kind` lists one expression of every deviate kind of
the expression tape, with fixed and with sampled parameters, for the
sampler's checks.
"""

from __future__ import annotations

__all__ = ["event_tree_scale_xml", "every_deviate_kind"]


def every_deviate_kind(expr, mission_time) -> list:
    """Every deviate kind with fixed parameters, then with parameters drawn
    from one shared uniform ``u`` (one tape slot), histograms with sampled
    weights, and ops over deviates.  ``expr`` is a package's ``mef.expr``
    module and ``mission_time`` its ``MissionTime()``, so each package
    builds the same list."""
    C = expr.ConstantExpression
    u = expr.UniformDeviate(C(0.5), C(2.0))
    return [
        expr.UniformDeviate(C(1.0), C(3.0)),
        expr.NormalDeviate(C(5.0), C(2.0)),
        expr.LognormalDeviate(C(1e-3), C(3.0), C(0.95)),
        expr.LognormalDeviate(C(-1.0), C(0.5)),
        expr.GammaDeviate(C(0.5), C(2.0)), expr.GammaDeviate(C(3.0), C(2.0)),
        expr.BetaDeviate(C(2.0), C(6.0)),
        expr.Histogram([C(0.0), C(1.0), C(3.0)], [C(1.0), C(3.0)]),
        expr.NormalDeviate(u, C(0.1)), expr.GammaDeviate(u, C(1.5)),
        expr.BetaDeviate(u, C(2.0)),
        expr.Histogram([C(0.0), C(1.0), C(3.0), C(4.0)],
                       [u, C(1.0), expr.Mul([u, u])]),
        expr.LognormalDeviate(expr.Mul([C(1e-3), u]), C(3.0), C(0.95)),
        expr.UniformDeviate(u, C(3.0)),
        expr.Add([u, expr.Exponential(C(1e-4), mission_time)]), C(0.25), u]


def event_tree_scale_xml(n_fe: int = 6, deviates: bool = False,
                         house_flip: bool = False) -> str:
    """The model as MEF XML text."""
    lines = ['<?xml version="1.0"?>', '<opsa-mef name="big-plant">',
             '  <define-initiating-event name="IE" event-tree="ET"/>',
             '  <define-event-tree name="ET">']
    for k in range(n_fe):
        lines.append(f'    <define-functional-event name="FE{k}"/>')
    for s in range(2 ** n_fe):
        lines.append(f'    <define-sequence name="seq{s}"/>')

    def fork(k: int, path_bits: int) -> str:
        if k == n_fe:
            return f'<sequence name="seq{path_bits}"/>'
        succ = fork(k + 1, path_bits)
        fail = fork(k + 1, path_bits | (1 << k))
        flip = ('<set-house-event name="maint"><constant value="true"/>'
                '</set-house-event>' if house_flip and k == 0 else '')
        return (f'<fork functional-event="FE{k}">'
                f'<path state="success">'
                f'<collect-formula><not><gate name="g{k}"/></not>'
                f'</collect-formula>{succ}</path>'
                f'<path state="failure">{flip}'
                f'<collect-formula><gate name="g{k}"/></collect-formula>'
                f'{fail}</path></fork>')

    def value(mean: str) -> str:
        if not deviates:
            return f'<float value="{mean}"/>'
        return (f'<lognormal-deviate><float value="{mean}"/>'
                '<float value="3"/><float value="0.95"/>'
                '</lognormal-deviate>')

    lines.append('    <initial-state>' + fork(0, 0) + '</initial-state>')
    lines.append('  </define-event-tree>')
    maint = '<gate name="maint-line"/>' if house_flip else ''
    for k in range(n_fe):
        lines.append(f'  <define-fault-tree name="FT{k}">')
        lines.append(
            f'    <define-gate name="g{k}"><or>'
            f'<basic-event name="a{k}"/><basic-event name="b{k}"/>'
            f'<basic-event name="common"/>{maint}</or></define-gate>')
        if house_flip and k == 0:
            lines.append('    <define-gate name="maint-line"><and>'
                         '<house-event name="maint"/>'
                         '<basic-event name="m"/></and></define-gate>')
        lines.append(f'    <define-basic-event name="a{k}">'
                     f'{value(f"{0.02 + 0.01 * k:.3f}")}'
                     f'</define-basic-event>')
        lines.append(f'    <define-basic-event name="b{k}">'
                     f'<float value="{0.05 + 0.005 * k:.3f}"/>'
                     f'</define-basic-event>')
        lines.append('  </define-fault-tree>')
    data = ('<define-basic-event name="common">'
            f'{value("0.01")}</define-basic-event>')
    if house_flip:
        data += ('<define-house-event name="maint"><constant value="false"/>'
                 '</define-house-event><define-basic-event name="m">'
                 '<float value="0.3"/></define-basic-event>')
    lines.append(f'  <model-data>{data}</model-data>')
    lines.append('</opsa-mef>')
    return "\n".join(lines)
