"""Config-driven crawler rulesets.

Counterpart of `gsky_tpu/index/rulesets.py`, with the same built-in
table letter for letter.  A rule is a filename regex whose named groups
give the acquisition timestamp, the namespace, an SRS override, a bbox
override and, for curvilinear products, a geolocation rule.  Rules load
from a JSON config (``rule_sets`` key) with the built-in table as
fallback; the first matching rule wins, with a catch-all ``default``
rule last.

Namespace modes:
- ``ns_dataset``: namespaces come from the file's own datasets/bands
  (the extractor's defaults stand),
- ``ns_path``: the regex's ``namespace`` group overrides every
  dataset's namespace,
- ``ns_combine``: ``<namespace group>_<dataset namespace>``.

Timestamps derive from the named groups: (year, julian_day) or
(year, month, day[, hour, minute, second]), or a ``start_*`` date.
"""

from __future__ import annotations

import datetime as dt
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

NS_PATH = "ns_path"
NS_DATASET = "ns_dataset"
NS_COMBINE = "ns_combine"

_ISO = "%Y-%m-%dT%H:%M:%S.000Z"


@dataclass
class GeoLocRule:
    """Pattern/template pair naming the geolocation x/y datasets
    (`ruleset.go:9-20`); templates may reference regex groups as
    ``{group}`` plus ``{filename}``."""
    x_dataset_pattern: str = ""
    x_dataset_template: str = ""
    y_dataset_pattern: str = ""
    y_dataset_template: str = ""
    x_band: int = 1
    y_band: int = 1
    line_offset: int = 0
    pixel_offset: int = 0
    line_step: int = 1
    pixel_step: int = 1

    @classmethod
    def from_json(cls, j: Dict) -> "GeoLocRule":
        return cls(
            x_dataset_pattern=j.get("x_dataset_pattern", ""),
            x_dataset_template=j.get("x_dataset_template", ""),
            y_dataset_pattern=j.get("y_dataset_pattern", ""),
            y_dataset_template=j.get("y_dataset_template", ""),
            x_band=int(j.get("x_band") or 1),
            y_band=int(j.get("y_band") or 1),
            line_offset=int(j.get("line_offset") or 0),
            pixel_offset=int(j.get("pixel_offset") or 0),
            line_step=int(j.get("line_step") or 1),
            pixel_step=int(j.get("pixel_step") or 1))


@dataclass
class RuleSet:
    collection: str = ""
    namespace: str = NS_DATASET
    srs_text: str = ""            # "" = detect from the file
    proj4_text: str = ""
    pattern: str = ""
    match_full_path: bool = False
    bbox: Optional[List[float]] = None
    geo_loc: Optional[GeoLocRule] = None
    compute_stats: bool = False
    _re: Optional[re.Pattern] = field(default=None, repr=False)

    def regex(self) -> re.Pattern:
        if self._re is None:
            self._re = re.compile(self.pattern)
        return self._re

    def match(self, path: str) -> Optional[re.Match]:
        hay = path if self.match_full_path else os.path.basename(path)
        return self.regex().search(hay)

    @classmethod
    def from_json(cls, j: Dict) -> "RuleSet":
        return cls(
            collection=j.get("collection", ""),
            namespace=j.get("namespace", NS_DATASET) or NS_DATASET,
            srs_text=j.get("srs_text", ""),
            proj4_text=j.get("proj4_text", ""),
            pattern=j.get("pattern", ""),
            match_full_path=bool(j.get("match_full_path", False)),
            bbox=list(j["bbox"]) if j.get("bbox") else None,
            geo_loc=GeoLocRule.from_json(j["geo_loc"])
            if j.get("geo_loc") else None,
            compute_stats=bool(j.get("compute_stats", False)))


def timestamp_from_groups(groups: Dict[str, str]) -> Optional[str]:
    """ISO timestamp from a rule match's named groups (the reference
    derives times from year/julian_day or calendar groups)."""
    g = {k: v for k, v in groups.items() if v is not None}
    try:
        if "year" in g and "julian_day" in g:
            d = dt.datetime(int(g["year"]), 1, 1,
                            tzinfo=dt.timezone.utc) \
                + dt.timedelta(days=int(g["julian_day"]) - 1)
        elif "year" in g and "month" in g and "day" in g:
            d = dt.datetime(int(g["year"]), int(g["month"]),
                            int(g["day"]), tzinfo=dt.timezone.utc)
        elif "start_year" in g:
            d = dt.datetime(int(g["start_year"]),
                            int(g.get("start_month", 1)),
                            int(g.get("start_day", 1)),
                            tzinfo=dt.timezone.utc)
        else:
            return None
        if "hour" in g:
            d = d.replace(hour=int(g["hour"]),
                          minute=int(g.get("minute", 0)),
                          second=int(g.get("second", 0)))
        return d.strftime(_ISO)
    except (ValueError, OverflowError):
        return None


def apply_ruleset(rule: RuleSet, m: re.Match, record: Dict,
                  path: str) -> Dict:
    """Fold one matched rule into an extractor record (in place):
    pattern-derived timestamps, namespace mode, SRS/bbox overrides, and
    the geolocation rule."""
    groups = m.groupdict()
    stamp = timestamp_from_groups(groups)
    ns_group = groups.get("namespace")
    for ds in record.get("geo_metadata", []):
        # a matched product rule is more specific than the extractor's
        # generic filename-date fallback, but never overrides a real
        # time axis read from file content
        if stamp and (not ds.get("timestamps")
                      or ds.get("timestamps_source") == "filename"):
            ds["timestamps"] = [stamp]
        if ns_group:
            if rule.namespace == NS_PATH:
                ds["namespace"] = ns_group
            elif rule.namespace == NS_COMBINE:
                ds["namespace"] = f"{ns_group}_{ds['namespace']}"
        if rule.srs_text or rule.proj4_text:
            ds["proj_wkt"] = rule.srs_text or ds.get("proj_wkt", "")
            ds["proj4"] = rule.proj4_text or ds.get("proj4", "")
        if rule.bbox and len(rule.bbox) >= 4:
            x0, y0, x1, y1 = (rule.bbox[0], rule.bbox[1], rule.bbox[2],
                              rule.bbox[3])
            x0, x1 = min(x0, x1), max(x0, x1)
            y0, y1 = min(y0, y1), max(y0, y1)
            ds["polygon"] = (f"POLYGON (({x0} {y0},{x1} {y0},"
                             f"{x1} {y1},{x0} {y1},{x0} {y0}))")
        if rule.geo_loc is not None:
            ctx = dict(groups, filename=path)
            try:
                xds = rule.geo_loc.x_dataset_template.format(**ctx)
                yds = rule.geo_loc.y_dataset_template.format(**ctx)
            except (KeyError, IndexError):
                continue
            # our geoloc loader takes variable names; accept either a
            # bare name or the reference's NETCDF:"path":var form
            def var_of(s: str) -> str:
                return s.rsplit(":", 1)[-1].strip('"')

            ds["geo_loc"] = {
                "x_var": var_of(xds), "y_var": var_of(yds),
                "line_offset": float(rule.geo_loc.line_offset),
                "pixel_offset": float(rule.geo_loc.pixel_offset),
                "line_step": float(rule.geo_loc.line_step),
                "pixel_step": float(rule.geo_loc.pixel_step),
                "srs": "EPSG:4326"}
    return record


def match_rule(path: str,
               rules: Optional[List[RuleSet]] = None):
    """(rule, match) of the first matching rule, or (None, None)."""
    for rule in (rules if rules is not None else BUILTIN_RULESETS):
        m = rule.match(path)
        if m is not None:
            return rule, m
    return None, None


def load_rulesets(path: str) -> List[RuleSet]:
    """Rule list from a JSON config ({"rule_sets": [...]}); the
    built-in table appends as fallback."""
    with open(path) as fp:
        j = json.load(fp)
    rules = [RuleSet.from_json(r) for r in j.get("rule_sets", [])]
    return rules + BUILTIN_RULESETS


_WGS84_PROJ4 = "+proj=longlat +datum=WGS84 +no_defs"

# Built-in product rules — the same product families the reference's
# table covers (`ruleset.go:71-242`), with patterns written against the
# products' public naming conventions.
BUILTIN_RULESETS: List[RuleSet] = [
    RuleSet(collection="landsat", pattern=(
        r"LC(?P<mission>\d)(?P<path>\d{3})(?P<row>\d{3})"
        r"(?P<year>\d{4})(?P<julian_day>\d{3})"
        r"(?P<level>[A-Za-z0-9]+)_(?P<band>[A-Za-z0-9]+)")),
    RuleSet(collection="modis43A4", pattern=(
        r"^LHTC_(?P<year>\d{4})(?P<julian_day>\d{3})\."
        r"(?P<horizontal>h\d\d)(?P<vertical>v\d\d)\."
        r"(?P<resolution>\d{3})\.\d+")),
    RuleSet(collection="lhtc", namespace=NS_COMBINE, pattern=(
        r"^COMPOSITE_(?P<namespace>LOW|HIGH).+_PER_20\.nc$")),
    RuleSet(collection="modis1", pattern=(
        r"^(?P<product>MCD\d\d[A-Z]\d)\.A(?P<year>\d{4})"
        r"(?P<julian_day>\d{3})\.(?P<horizontal>h\d\d)"
        r"(?P<vertical>v\d\d)\.(?P<resolution>\d{3})\.\d+")),
    RuleSet(collection="modis-fc", namespace=NS_PATH, pattern=(
        r"^(?P<product>FC)\.v302\.(?P<root>MCD43A4)\."
        r"h(?P<horizontal>\d\d)v(?P<vertical>\d\d)\.(?P<year>\d{4})\."
        r"(?P<resolution>\d{3})\.(?P<namespace>[A-Z0-9]+)\.jp2$")),
    RuleSet(collection="modis2", pattern=(
        r"M(?:OD|YD)(?P<product>[0-9]+_[A-Z0-9]+)\.A\d+\.\d+\."
        r"(?P<version>\d{3})\.(?P<year>\d{4})(?P<julian_day>\d{3})"
        r"(?P<hour>\d\d)(?P<minute>\d\d)(?P<second>\d\d)")),
    RuleSet(collection="modisJP", pattern=(
        r"^(?P<product>FC)\.v302\.(?P<root>MCD\d\d[A-Z]\d)\."
        r"h(?P<horizontal>\d\d)v(?P<vertical>\d\d)\.(?P<year>\d{4})\."
        r"(?P<resolution>\d{3})\.")),
    RuleSet(collection="modisJP_LR", pattern=(
        r"^(?P<product>FC_LR)\.v302\.(?P<root>MCD\d\d[A-Z]\d)\."
        r"h(?P<horizontal>\d\d)v(?P<vertical>\d\d)\.(?P<year>\d{4})\."
        r"(?P<resolution>\d{3})\.")),
    RuleSet(collection="sentinel2", namespace=NS_PATH, pattern=(
        r"^T(?P<zone>\d\d)(?P<tile>[A-Z]+)_(?P<year>\d{4})"
        r"(?P<month>\d\d)(?P<day>\d\d)T(?P<hour>\d\d)(?P<minute>\d\d)"
        r"(?P<second>\d\d)_(?P<namespace>B\d\d)\.jp2$")),
    RuleSet(collection="himawari8", pattern=(
        r"^(?P<year>\d{4})(?P<month>\d\d)(?P<day>\d\d)(?P<hour>\d\d)"
        r"(?P<minute>\d\d)(?P<second>\d\d)-P1S-"
        r"(?P<product>ABOM[0-9A-Z_]+)-PRJ_GEOS141_"
        r"(?P<resolution>\d+)-HIMAWARI8-AHI")),
    RuleSet(collection="agdc_landsat1", pattern=(
        r"LS(?P<mission>\d)_(?P<sensor>[A-Z]+)_(?P<correction>[A-Z]+)_"
        r"(?P<epsg>\d+)_(?P<x_coord>-?\d+)_(?P<y_coord>-?\d+)_"
        r"(?P<year>\d{4})\.")),
    RuleSet(collection="agdc_landsat2", pattern=(
        r"LS(?P<mission>\d)_OLI_(?P<sensor>[A-Z]+)_(?P<product>[A-Z]+)_"
        r"(?P<epsg>\d+)_(?P<x_coord>-?\d+)_(?P<y_coord>-?\d+)_"
        r"(?P<year>\d{4})\.")),
    RuleSet(collection="elevation_ga", pattern=(
        r"^Elevation_1secSRTM_DEMs_v1\.0_DEM-S_Tiles_"
        r"e(?P<longitude>\d+)s(?P<latitude>\d+)dems\.nc$")),
    RuleSet(collection="agdc_dem", pattern=(
        r"SRTM_(?P<product>[A-Z]+)_(?P<x_coord>-?\d+)_"
        r"(?P<y_coord>-?\d+)_(?P<year>\d{4})(?P<month>\d\d)"
        r"(?P<day>\d\d)(?P<hour>\d\d)(?P<minute>\d\d)"
        r"(?P<second>\d\d)")),
    RuleSet(collection="chirps2.0", namespace=NS_PATH,
            proj4_text=_WGS84_PROJ4, srs_text="EPSG:4326", pattern=(
                r"^(?P<namespace>chirps)-v2\.0\.(?P<year>\d{4})\."
                r"dekads\.nc$")),
    RuleSet(collection="era-interim", namespace=NS_PATH, pattern=(
        r"^(?P<namespace>[a-z0-9]+)_(?P<accum>\dhrs)_ERAI_historical_"
        r"(?P<levels>[a-z\-]+)_(?P<start_year>\d{4})"
        r"(?P<start_month>\d\d)(?P<start_day>\d\d)_(?P<end_year>\d{4})"
        r"(?P<end_month>\d\d)(?P<end_day>\d\d)\.nc$")),
    RuleSet(collection="sentinel2_ard_nbar_nbart", namespace=NS_PATH,
            pattern=(
                r"_(?P<year>\d{4})(?P<month>\d\d)(?P<day>\d\d)T"
                r"(?P<hour>\d\d)(?P<minute>\d\d)(?P<second>\d\d).*_"
                r"(?P<namespace>NBART?[\w\d_]+)\.TIF")),
    RuleSet(collection="sentinel2_ard_qa_supp", namespace=NS_PATH,
            pattern=(
                r"_(?P<year>\d{4})(?P<month>\d\d)(?P<day>\d\d)T"
                r"(?P<hour>\d\d)(?P<minute>\d\d)(?P<second>\d\d)_.+0\d_"
                r"(?P<namespace>[\w\d_]+)\.TIF")),
    RuleSet(collection="barra", pattern=(
        r"(?P<year>\d{4})(?P<month>\d\d)(?P<day>\d\d)T"
        r"(?P<hour>\d\d)(?P<minute>\d\d)Z\.nc")),
    # the reference's pattern is the bare substring "roms"
    # (`ruleset.go` inherits the mis-tag risk on any basename containing
    # it); anchored here to a separated token + .nc suffix so unrelated
    # NetCDFs don't acquire a whole-world footprint + lon_v/lat_v
    # geolocation they don't have
    RuleSet(collection="ereef", srs_text="EPSG:4326",
            proj4_text=_WGS84_PROJ4,
            pattern=r"(?:^|[_.-])roms(?=[_.-]).*\.nc$",
            bbox=[-180.0, 90.0, 180.0, -90.0],
            geo_loc=GeoLocRule(
                x_dataset_pattern=r"(?P<filename>.*)",
                x_dataset_template='NETCDF:"{filename}":lon_v',
                y_dataset_pattern=r"(?P<filename>.*)",
                y_dataset_template='NETCDF:"{filename}":lat_v')),
    # catch-all: detection-only (`ruleset.go`'s `default` rule)
    RuleSet(collection="default", pattern=r".+"),
]
